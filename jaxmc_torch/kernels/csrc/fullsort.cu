// K11 fullsort_dedup: the dedup and the two stable compactions of the
// level engine's full-sort step, after its sort.
//
// Replaces: jaxmc/backend/bfs.py:1820-1851, the JAXMC_LEVEL_RANKMERGE=0
// branch of _get_step's step: after the stable [SC+C, K+1]-key sort of
// the seen table and the candidates (lax.sort, outside any Pallas
// kernel; the port sorts with K18 sort_keys, sort.cu), the
// first-of-run `new` mask, `keep`, and the compactions
// lax.sort((1 - new, cidx)) and lax.sort((1 - keep, keys...)), both
// with num_keys=1 and is_stable=True, i.e. stable partitions.
//
// Inputs, in sorted order: skeys [N, K] int32 (N = SC + C), sflag [N]
// int32 (0 for a seen row, 1 for a candidate), perm [N] int32 (each
// row's index before the sort), SC and C.  Per row i:
//   rvalid   = skeys[i][0] == 0
//   neq_prev = i == 0 || skeys[i] != skeys[i - 1]   (any word)
//   new      = sflag[i] && rvalid && neq_prev
//   keep     = (!sflag[i] && rvalid) || new
// Outputs: new_cidx [C] int32, the stable compaction of perm - SC over
// `new` (its first new_count entries); seen2 [SC, K] int32, the stable
// compaction of the keys over `keep` (its first seen_count2 rows); and
// counts int64[2] = (new_count, seen_count2), left on the device.
// What must match the reference: new_cidx over its first new_count
// entries and seen2 over its first seen_count2 rows, bit for bit.  The
// kernel writes nothing past them (the reference's partition puts the
// unset entries there); nothing reads them: the level step masks
// new_cidx by new_count, and it marks the seen rows past the live
// prefix invalid before the next level's sort.
// Bound on the card: bytes.  Each sorted key row, flag and perm read
// once, 4 bytes per new index and K * 4 bytes per kept row written.
// Design: one launch, one block a tile, a single-pass stable compaction
// with decoupled look-back (lookback.cuh), one look-back for each of the
// two counts.
//   A tile is T = 256 * R rows, R = 16, 8, 4, 2 or 1 as K = 1, K <= 3, 6,
//   12 or more (its key words at most 24 KB of shared memory).  The block
//   copies its rows' K words, its flags and the row before it straight
//   into shared memory with cp.async (16-byte copies where aligned), so
//   no load is staged in registers, and compares neighbours there.  Row j
//   of the tile is thread j % 256's in round j / 256, so a warp's ballot
//   of `new` and of `keep` covers 32 consecutive rows; the ballots go to
//   shared memory, and a scan of the R * 8 warp counts ranks every row
//   within the tile.  Warp 0 publishes the tile's new count and looks
//   back over earlier tiles' words, warp 1 the same for the kept count,
//   side by side, while the other warps stage the kept rows' tile
//   positions (over the flags, dead by then).  Then each warp writes its
//   new rows' perm - SC (perm read here; a round's new rows of a warp are
//   consecutive in new_cidx) and the kept rows' K words as contiguous
//   runs (lane l word l % K of row l / K).  The tile with the last ticket
//   writes the counts.  Tiles are ordered by a ticket from an atomic
//   counter, not by blockIdx: a tile with a smaller ticket has started,
//   so the look-back never waits on a tile that is not resident; the
//   tile with the last ticket sets the counter back to 0.
//   What sets the time (`PERF.md` §6, from per-phase clock64 stamps): a
//   tile's life is its ticket, its copies, its ranking and a look-back
//   that waits for the slowest of the nearest earlier tiles to publish,
//   so throughput follows the tiles resident at once: the kernel keeps
//   no load or ballot in registers and stages 32 KB at K = 3.
//   Persistent blocks that prefetch their next tile measured slower: a
//   tile's count then waits for its block's previous look-back.
// Scratch: a workspace the wrapper caches for each device and stream (the
// two counts' status words, the ticket); the words carry the call's
// epoch, so nothing is cleared between calls, and calls on one stream
// run one after another (the wrapper enqueues each under a lock and
// refuses CUDA graph capture, which would replay one epoch).  Every output element is written by
// one thread, the look-back's sums do not depend on timing and nothing
// else is atomic, so the result is the same on every run.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// key words a tile stages in shared memory, at most (chosen by a sweep on
// the card, PERF.md)
constexpr int kTileWords = 6144;
// the widest key: R = 1 stages 256 * K + K + 256 words, under the 227 KB
// a block may use
constexpr int kMaxK = 200;

int rows_for(int k) {
  int r = 16;
  while (r > 1 && kThreads * r * k > kTileWords) r >>= 1;
  return r;
}

// the tile's key rows, its flags (then the kept rows' tile positions) and
// the row before the tile
size_t smem_bytes(int k, int r) {
  const size_t t = static_cast<size_t>(kThreads) * r;
  return (t * k + k + t) * sizeof(int32_t);
}

// copies from global to shared memory that hold no register: 16 bytes
// (both ends aligned) or 4
__device__ __forceinline__ void cp_async16(int32_t* dst, const int32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
               "l"(src)
               : "memory");
}

// this thread's copies landed (the block's, after a __syncthreads)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// n words from src to shared dst, 16 bytes a copy when both are aligned
__device__ __forceinline__ void copy_words(int32_t* dst, const int32_t* src,
                                          int n) {
  int q0 = 0;
  if (((reinterpret_cast<uintptr_t>(src) |
        reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    const int nv = n >> 2;
    for (int q = threadIdx.x; q < nv; q += kThreads)
      cp_async16(dst + 4 * q, src + 4 * q);
    q0 = nv << 2;
  }
  for (int q = q0 + threadIdx.x; q < n; q += kThreads)
    cp_async4(dst + q, src + q);
}

// the kept rows' K words from shared memory to seen2, a warp writing
// consecutive rows: lane l writes word l % K of row l / K
__device__ __forceinline__ void write_rows(const int32_t* s_keys,
                                           const int32_t* s_src,
                                           int32_t* __restrict__ seen2,
                                           int tk, int64_t ek, int k,
                                           int64_t sc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (k <= 32) {
    const int rpw = 32 / k, my_r = lane / k, my_w = lane - my_r * k;
    if (my_r >= rpw) return;
    for (int lr = warp * rpw + my_r; lr < tk; lr += kWarps * rpw) {
      const int64_t out = ek + lr;
      if (out < sc) seen2[out * k + my_w] = s_keys[s_src[lr] * k + my_w];
    }
    return;
  }
  for (int lr = warp; lr < tk; lr += kWarps) {
    const int64_t out = ek + lr;
    if (out >= sc) continue;
    for (int w = lane; w < k; w += 32)
      seen2[out * k + w] = s_keys[s_src[lr] * k + w];
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads) fullsort_pass_kernel(
    const int32_t* __restrict__ skeys, const int32_t* __restrict__ sflag,
    const int32_t* __restrict__ perm, int32_t* __restrict__ new_cidx,
    int32_t* __restrict__ seen2, int64_t* __restrict__ counts,
    uint64_t* __restrict__ st_new, uint64_t* __restrict__ st_keep,
    uint32_t* __restrict__ ticket, int64_t n, int k, int64_t sc, int64_t c,
    int ntiles, uint32_t epoch) {
  constexpr int T = kThreads * R;
  constexpr int M = R * kWarps;
  extern __shared__ int4 smem4[];
  int32_t* s_keys = reinterpret_cast<int32_t*>(smem4);
  int32_t* s_flag = s_keys + T * k;
  int32_t* s_src = s_flag;  // the flags are dead once the rows are ranked
  int32_t* s_prev = s_flag + T;
  __shared__ int s_cn[M], s_ck[M];
  __shared__ unsigned s_bn[M], s_bk[M];
  __shared__ int s_tile, s_tn, s_tk;
  __shared__ uint32_t s_en, s_ek;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = jmc_lb::take_ticket(ticket, ntiles, &s_tile);
  const int64_t base = static_cast<int64_t>(tile) * T;
  const int64_t left = n - base;
  const int nrows = left <= 0 ? 0 : (left >= T ? T : static_cast<int>(left));
  const int32_t* src = skeys + base * k;
  // the tile's keys, flags and the row before it, copied straight to
  // shared memory
  copy_words(s_keys, src, nrows * k);
  copy_words(s_flag, sflag + base, nrows);
  if (tid < k && base > 0 && nrows > 0) cp_async4(s_prev + tid, src - k + tid);
  cp_async_wait_all();
  __syncthreads();
  // the flags: each warp's ballots go to shared memory, so nothing is
  // held in registers across the look-back
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = r * kThreads + tid;
    bool is_new = false, keep = false;
    if (j < nrows) {
      const int32_t* row = s_keys + j * k;
      const int32_t* prev = j ? row - k : s_prev;
      bool neq = base + j == 0;
      for (int w = 0; w < k; ++w) neq |= row[w] != prev[w];
      const bool rvalid = row[0] == 0, cand = s_flag[j] != 0;
      is_new = cand && rvalid && neq;
      keep = (!cand && rvalid) || is_new;
    }
    const unsigned bn = __ballot_sync(jmc_lb::kFull, is_new);
    const unsigned bk = __ballot_sync(jmc_lb::kFull, keep);
    if (lane == 0) {
      s_bn[r * kWarps + warp] = bn;
      s_bk[r * kWarps + warp] = bk;
      s_cn[r * kWarps + warp] = __popc(bn);
      s_ck[r * kWarps + warp] = __popc(bk);
    }
  }
  __syncthreads();
  // exclusive scans of the warp counts in row order (round-major)
  if (warp == 0) {
    int cn = 0, ck = 0;
    for (int q0 = 0; q0 < M; q0 += 32) {
      const int q = q0 + lane;
      const int vn = q < M ? s_cn[q] : 0, vk = q < M ? s_ck[q] : 0;
      int xn = vn, xk = vk;
      for (int o = 1; o < 32; o <<= 1) {
        const int yn = __shfl_up_sync(jmc_lb::kFull, xn, o);
        const int yk = __shfl_up_sync(jmc_lb::kFull, xk, o);
        if (lane >= o) {
          xn += yn;
          xk += yk;
        }
      }
      if (q < M) {
        s_cn[q] = cn + xn - vn;
        s_ck[q] = ck + xk - vk;
      }
      cn += __shfl_sync(jmc_lb::kFull, xn, 31);
      ck += __shfl_sync(jmc_lb::kFull, xk, 31);
    }
    if (lane == 0) {
      s_tn = cn;
      s_tk = ck;
    }
  }
  __syncthreads();
  const int tn = s_tn, tk = s_tk;
  // two look-backs side by side: warp 0 the new count, warp 1 the kept
  if (warp < 2) {
    uint64_t* st = warp == 0 ? st_new : st_keep;
    const uint32_t own = static_cast<uint32_t>(warp == 0 ? tn : tk);
    const uint32_t ex = jmc_lb::look_back(st, tile, epoch, own);
    if (lane == 0) {
      (warp == 0 ? s_en : s_ek) = ex;
      if (tile == ntiles - 1) counts[warp] = static_cast<int64_t>(ex) + own;
    }
  }
  // stage the kept rows' tile positions
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const unsigned bk = s_bk[r * kWarps + warp];
    if ((bk >> lane) & 1u)
      s_src[s_ck[r * kWarps + warp] + __popc(bk & below)] =
          r * kThreads + tid;
  }
  __syncthreads();
  const int64_t exn = s_en, exk = s_ek;
  // a warp's new rows of a round are consecutive in new_cidx
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const unsigned bn = s_bn[r * kWarps + warp];
    if ((bn >> lane) & 1u) {
      const int j = r * kThreads + tid;
      const int64_t pos = exn + s_cn[r * kWarps + warp] + __popc(bn & below);
      if (pos < c) new_cidx[pos] = perm[base + j] - static_cast<int32_t>(sc);
    }
  }
  write_rows(s_keys, s_src, seen2, tk, exk, k, sc);
}

template <int R>
cudaError_t launch(const int32_t* skeys, const int32_t* sflag,
                   const int32_t* perm, int32_t* new_cidx, int32_t* seen2,
                   int64_t* counts, uint64_t* st_new, uint64_t* st_keep,
                   uint32_t* ticket, int64_t n, int k, int64_t sc, int64_t c,
                   int ntiles, uint32_t epoch, cudaStream_t stream) {
  const size_t smem = smem_bytes(k, R);
  // past the 48 KB a block gets without asking (static words included)
  if (smem > 46 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fullsort_pass_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  fullsort_pass_kernel<R><<<ntiles, kThreads, smem, stream>>>(
      skeys, sflag, perm, new_cidx, seen2, counts, st_new, st_keep, ticket,
      n, k, sc, c, ntiles, epoch);
  return cudaGetLastError();
}

}  // namespace

extern "C" int jmc_fullsort_max_k() { return kMaxK; }

// rows a tile holds at key width k
extern "C" int jmc_fullsort_tile_rows(int k) {
  return kThreads * rows_for(k);
}

// K11's workspace for `tiles` tiles: the new and the kept counts' status
// words [tiles] uint64 each and the ticket; zeros when made
extern "C" int64_t jmc_fullsort_workspace_bytes(int tiles) {
  return static_cast<int64_t>(tiles) * 16 + 8;
}

extern "C" cudaError_t jmc_fullsort_dedup(
    const int32_t* skeys, const int32_t* sflag, const int32_t* perm,
    int32_t* new_cidx, int32_t* seen2, int64_t* counts, void* ws, int64_t n,
    int k, int64_t sc, int64_t c, int ntiles, int ws_tiles, int epoch,
    cudaStream_t stream) {
  if (k < 1 || k > kMaxK) return cudaErrorInvalidValue;
  uint64_t* st_new = static_cast<uint64_t*>(ws);
  uint64_t* st_keep = st_new + ws_tiles;
  uint32_t* ticket = reinterpret_cast<uint32_t*>(st_keep + ws_tiles);
  const uint32_t e = static_cast<uint32_t>(epoch);
#define JMC_LAUNCH(R)                                                      \
  return launch<R>(skeys, sflag, perm, new_cidx, seen2, counts, st_new,   \
                   st_keep, ticket, n, k, sc, c, ntiles, e, stream)
  switch (rows_for(k)) {
    case 16:
      JMC_LAUNCH(16);
    case 8:
      JMC_LAUNCH(8);
    case 4:
      JMC_LAUNCH(4);
    case 2:
      JMC_LAUNCH(2);
    default:
      JMC_LAUNCH(1);
  }
#undef JMC_LAUNCH
}
