// K4 merge_sorted: merge the sorted candidate keys that are new into the
// sorted seen table, in O(SC + N) work and two launches.
//
// Replaces: the gather, compare and scatter bodies of
// jaxmc/backend/bfs.py:285 _rank_merge (multikey=True, called from the
// level step at bfs.py:1814, the resident level at :2461 and the mesh
// merge at jaxmc/backend/mesh.py:663): the adjacent-duplicate flags, the
// `new` verdict, the cumsum compaction to nk_sidx, the scatter-add
// histogram of the new keys' lower bounds, its cumsum and the rank
// scatter into seen2.  The stable key sort before it (lax.sort, a
// primitive the reference leaves to the compiler) is K18 sort_keys
// (sort.cu).
//
// Bound on the card: bytes.  The live seen rows are read once
// (count*K*4) and the whole SC-row table written once (SC*K*4); every
// sorted key is read once for the duplicate check (N*K*4) with its
// `found` byte, the index and lower bound of each new key are read
// (new*8), and nk_sidx is written (N*4).
//
// Design: two launches and nothing between them.
//   1 (merge_new_kernel)   a tile of kThreads*items sorted keys comes
//      into shared memory with 16-byte loads, the key before the tile
//      with it; new = valid & !found & (key != previous key), one ballot
//      a warp and item; the tile's count goes through a decoupled
//      look-back (lookback.cuh) for its exclusive prefix; each new key
//      j writes nk_sidx[j] and the pair (its sorted position, its lower
//      bound clamped to [0, SC]).  The last tile writes new_count and
//      seen_count2.
//   2 (merge_rows_kernel)  new key j lands at t_j = lb_j + j, strictly
//      increasing in j (the keys are sorted, so lb is nondecreasing).
//      A block owns output rows [p0, p1): two 32-ary warp searches over
//      t give the new keys jlo..jhi that land there, so its seen rows
//      are the run p0 - jlo .. (contiguous: row p is seen row p - #new
//      keys before it); the run comes in with 16-byte loads, the new
//      keys are gathered behind it, a bitmap of their rows and its
//      prefix popcounts place each output row, and the block writes its
//      rows [p0, p1) as one run of 16-byte stores, the invalid tail
//      (1, SENTINEL...) past count2 included.  Every block also zeroes
//      its share of nk_sidx[new_count, N) and of launch 1's status
//      words.
// No cumsum, histogram or SC-row scratch; new_count is read on the
// device.  The tile status words and the ticket live in a workspace that
// is zero between calls: launch 1's last tile returns the ticket to 0,
// launch 2 clears the status words behind launch 1, and the workspace
// is made with zeros.  So a call keeps nothing across calls and can be
// captured in a CUDA graph.  Rows past SC are dropped (the engine grows
// SC so that count + N <= SC before every merge).  SC + N < 2^31.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int32_t kSentinel = 0x7FFFFFFF;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
// the dynamic shared memory a block takes without opting in (48 KB less
// the kernels' static shared memory, at most 1 KB)
constexpr int kSmemDefault = 47 * 1024;
// the most a block may opt in to
constexpr int kSmemMax = 232448 - 1024;

__host__ __device__ __forceinline__ int pad4(int w) { return (w + 3) & ~3; }

// a runtime call's error, taken off the thread's last-error state so that
// the next call's check after its launch does not report it again
inline cudaError_t fail(cudaError_t err) {
  cudaGetLastError();
  return err;
}

// the word phase of p in its 16-byte sector (0..3)
__device__ __forceinline__ int phase4(const int32_t* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3u);
}

// s[o + i] = g[i] for i in [0, nw), with o = phase4(g), so that g's
// 16-byte middle lands on 16-byte boundaries of s as well: a scalar head,
// 16-byte loads and stores, a scalar tail.  s holds nw + 3 words from a
// 16-byte boundary.  Returns o.
__device__ int stage_run(const int32_t* __restrict__ g, int nw,
                         int32_t* __restrict__ s) {
  const int o = phase4(g);
  const int h = min((4 - o) & 3, nw), nv = (nw - h) >> 2;
  for (int i = threadIdx.x; i < h; i += blockDim.x) s[o + i] = g[i];
  const int4* gv = reinterpret_cast<const int4*>(g + h);
  int4* sv = reinterpret_cast<int4*>(s + o + h);
  for (int v = threadIdx.x; v < nv; v += blockDim.x) sv[v] = __ldg(gv + v);
  for (int i = h + 4 * nv + threadIdx.x; i < nw; i += blockDim.x)
    s[o + i] = g[i];
  return o;
}

// Launch 1: a tile of ITEMS * kThreads sorted keys (thread t on rows
// t, t + kThreads, ...): the new flags, the tile's count and its
// look-back, the compaction of the new keys' indices and pairs.
template <int ITEMS>
__global__ void __launch_bounds__(kThreads)
    merge_new_kernel(const int32_t* __restrict__ skeys,
                     const bool* __restrict__ found,
                     const int32_t* __restrict__ sidx,
                     const int32_t* __restrict__ lb,
                     int32_t* __restrict__ nk_sidx, int2* __restrict__ pairs,
                     int32_t* __restrict__ scalars, uint32_t* ticket,
                     uint64_t* status, int64_t count, int64_t n, int64_t sc,
                     int k, int ntiles) {
  extern __shared__ int4 smem4[];
  int32_t* sm = reinterpret_cast<int32_t*>(smem4);
  __shared__ int s_tile;
  __shared__ int s_off[ITEMS * kWarps];
  __shared__ uint32_t s_excl;
  const int tile = jmc_lb::take_ticket(ticket, ntiles, &s_tile);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t r0 = static_cast<int64_t>(tile) * (ITEMS * kThreads);
  const int64_t left = n - r0;
  const int nt = static_cast<int>(left < ITEMS * kThreads ? left
                                                          : ITEMS * kThreads);
  // rows [r0 - 1, r0 + nt): the key before the tile comes in with it
  const int pre = r0 > 0 ? 1 : 0;
  const int o = stage_run(skeys + (r0 - pre) * k, (nt + pre) * k, sm);
  __syncthreads();
  const int32_t* kt = sm + o + pre * k;  // row i of the tile at kt + i*k
  uint32_t masks[ITEMS];
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const int i = q * kThreads + threadIdx.x;
    bool fresh = false;
    if (i < nt) {
      const int32_t* row = kt + i * k;
      if (row[0] == 0 && !found[r0 + i]) {
        bool neq = r0 + i == 0;
        for (int j = 0; j < k && !neq; ++j) neq = row[j] != row[j - k];
        fresh = neq;
      }
    }
    masks[q] = __ballot_sync(kFull, fresh);
    if (lane == 0) s_off[q * kWarps + warp] = __popc(masks[q]);
  }
  __syncthreads();
  if (warp == 0) {
    // exclusive scan of the ITEMS * kWarps counts in row order (item
    // major, then warp): lane l sums entries 4l .. 4l + 3
    constexpr int kM = ITEMS * kWarps;  // at most 128
    int v[4], s = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = 4 * lane + e;
      v[e] = idx < kM ? s_off[idx] : 0;
      s += v[e];
    }
    int x = s;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    const uint32_t agg = static_cast<uint32_t>(__shfl_sync(kFull, x, 31));
    int run = x - s;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = 4 * lane + e;
      if (idx < kM) s_off[idx] = run;
      run += v[e];
    }
    const uint32_t excl = jmc_lb::look_back(status, tile, 0u, agg);
    if (lane == 0) {
      s_excl = excl;
      if (tile == ntiles - 1) {
        scalars[0] = static_cast<int32_t>(excl + agg);
        scalars[1] = static_cast<int32_t>(count + excl + agg);
      }
    }
  }
  __syncthreads();
  const int64_t base = s_excl;
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    if (!((masks[q] >> lane) & 1u)) continue;
    const int64_t r = r0 + q * kThreads + threadIdx.x;
    const int64_t j = base + s_off[q * kWarps + warp] +
                      __popc(masks[q] & ((1u << lane) - 1u));
    nk_sidx[j] = sidx[r];
    int64_t b = lb[r];
    b = b < 0 ? 0 : (b > sc ? sc : b);
    pairs[j] = make_int2(static_cast<int32_t>(r), static_cast<int32_t>(b));
  }
}

// #{j < nc : pairs[j].y + j < tgt} (the targets increase in j): a
// 32-ary search by one warp, each round 32 probes spread over [lo, hi)
__device__ int64_t count_below(const int2* __restrict__ pairs, int64_t nc,
                               int64_t tgt) {
  const int lane = threadIdx.x & 31;
  int64_t lo = 0, hi = nc;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int64_t span = hi - lo;
    const int64_t m = lo + span * (lane + 1) / 33;
    const bool below = static_cast<int64_t>(pairs[m].y) + m < tgt;
    const int c = __popc(__ballot_sync(kFull, below));
    const int64_t nlo = c ? lo + span * c / 33 + 1 : lo;
    const int64_t nhi = c < 32 ? lo + span * (c + 1) / 33 : hi;
    lo = nlo;
    hi = nhi;
  }
  const int64_t m = lo + lane;
  const bool below = m < hi && static_cast<int64_t>(pairs[m].y) + m < tgt;
  return lo + __popc(__ballot_sync(kFull, below));
}

// Launch 2: output rows [p0, p0 + R) of block p0 / R, and everyone's
// share of nk_sidx's zero tail and of the status words.
__global__ void __launch_bounds__(kThreads)
    merge_rows_kernel(const int32_t* __restrict__ seen,
                      const int32_t* __restrict__ skeys,
                      const int2* __restrict__ pairs,
                      const int32_t* __restrict__ scalars,
                      int32_t* __restrict__ seen2,
                      int32_t* __restrict__ nk_sidx, uint64_t* status,
                      int64_t count, int64_t n, int64_t sc, int k, int R,
                      int ntiles1, int64_t ntiles2) {
  extern __shared__ int4 smem4[];
  int32_t* buf = reinterpret_cast<int32_t*>(smem4);  // R*k + 3 words
  uint32_t* bm = reinterpret_cast<uint32_t*>(buf + pad4(R * k + 3));
  int32_t* before = reinterpret_cast<int32_t*>(bm + R / 32);
  __shared__ int64_t s_j[2];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t nc = scalars[0];
  const int64_t count2 = count + nc;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + t;
  for (int64_t i = first; i < ntiles1; i += stride) status[i] = 0;
  for (int64_t j = nc + first; j < n; j += stride) nk_sidx[j] = 0;
  if (blockIdx.x >= ntiles2) return;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * R;
  const int64_t p1 = p0 + R < sc ? p0 + R : sc;
  const int rows = static_cast<int>(p1 - p0);
  const int nbm = R / 32;
  if (warp < 2) {
    const int64_t tgt = warp ? p1 : p0;
    const int64_t c = tgt >= count2 ? nc : count_below(pairs, nc, tgt);
    if (lane == 0) s_j[warp] = c;
  }
  for (int i = t; i < nbm; i += kThreads) bm[i] = 0;
  __syncthreads();
  const int64_t jlo = s_j[0];
  const int nnew = static_cast<int>(s_j[1] - jlo);
  const int64_t live_end = p1 < count2 ? p1 : count2;
  const int live = live_end > p0 ? static_cast<int>(live_end - p0) : 0;
  const int nseen = live - nnew;
  // the seen run (row p0 - jlo on), then the new keys behind it
  const int o = stage_run(seen + (p0 - jlo) * k, nseen * k, buf);
  int32_t* nk = buf + o + nseen * k;
  for (int f = t; f < nnew * k; f += kThreads) {
    const int u = f / k, c = f - u * k;
    nk[f] = skeys[static_cast<int64_t>(pairs[jlo + u].x) * k + c];
  }
  for (int u = t; u < nnew; u += kThreads) {
    const int lp = static_cast<int>(pairs[jlo + u].y + jlo + u - p0);
    atomicOr(bm + (lp >> 5), 1u << (lp & 31));
  }
  __syncthreads();
  if (warp == 0) {  // exclusive prefix of the bitmap words' popcounts
    const int per = (nbm + 31) / 32;
    int s = 0;
    for (int e = 0; e < per; ++e) {
      const int idx = lane * per + e;
      if (idx < nbm) s += __popc(bm[idx]);
    }
    int x = s;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    int run = x - s;
    for (int e = 0; e < per; ++e) {
      const int idx = lane * per + e;
      if (idx < nbm) {
        before[idx] = run;
        run += __popc(bm[idx]);
      }
    }
  }
  __syncthreads();
  const int32_t* sr = buf + o;
  // output word i of the block (row lp = i / k, word c = i % k)
  auto word_at = [&](int lp, int c) -> int32_t {
    if (p0 + lp >= count2) return c ? kSentinel : 1;
    const uint32_t b = bm[lp >> 5];
    const int u = before[lp >> 5] + __popc(b & ((1u << (lp & 31)) - 1u));
    return ((b >> (lp & 31)) & 1u) ? nk[u * k + c] : sr[(lp - u) * k + c];
  };
  int32_t* g = seen2 + p0 * k;
  const int nw = rows * k;
  const int h = min((4 - phase4(g)) & 3, nw), nv = (nw - h) >> 2;
  for (int i = t; i < h; i += kThreads) g[i] = word_at(i / k, i % k);
  int4* gv = reinterpret_cast<int4*>(g + h);
  for (int v = t; v < nv; v += kThreads) {
    const int i = h + 4 * v;
    int lp = i / k, c = i - lp * k;
    int32_t e[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      e[q] = word_at(lp, c);
      if (++c == k) {
        c = 0;
        ++lp;
      }
    }
    gv[v] = make_int4(e[0], e[1], e[2], e[3]);
  }
  for (int i = h + 4 * nv + t; i < nw; i += kThreads)
    g[i] = word_at(i / k, i % k);
}

template <int ITEMS>
cudaError_t launch_new(int smem, int ntiles, cudaStream_t stream,
                       const int32_t* skeys, const bool* found,
                       const int32_t* sidx, const int32_t* lb,
                       int32_t* nk_sidx, int2* pairs, int32_t* scalars,
                       uint32_t* ticket, uint64_t* status, int64_t count,
                       int64_t n, int64_t sc, int k) {
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_new_kernel<ITEMS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return fail(err);
  }
  merge_new_kernel<ITEMS><<<ntiles, kThreads, smem, stream>>>(
      skeys, found, sidx, lb, nk_sidx, pairs, scalars, ticket, status, count,
      n, sc, k, ntiles);
  return cudaGetLastError();
}

}  // namespace

// K4 over the sorted keys skeys [n, k] (original indices sidx, probe
// found / lb) and the seen table [sc, k] with `count` live rows: seen2
// [sc, k], nk_sidx [n], scalars (new_count, seen_count2), the pairs
// scratch [n] int2.  `items` sorted keys a thread in launch 1 (8, 4, 2
// or 1) and `rows` output rows a block in launch 2 (a multiple of 32):
// kernels/ops.py merge_geometry.  `ws` is the workspace, zero between
// calls: word 0 K2's, word 1 the ticket, words 2 .. 2 + tiles the status.
extern "C" cudaError_t jmc_merge_sorted(
    const int32_t* seen, const int32_t* skeys, const int32_t* sidx,
    const bool* found, const int32_t* lb, int32_t* seen2, int32_t* nk_sidx,
    int32_t* pairs, int32_t* scalars, uint64_t* ws, int64_t count,
    int64_t n, int64_t sc, int k, int items, int rows, int ntiles,
    cudaStream_t stream) {
  const int64_t t1 = static_cast<int64_t>(items) * kThreads;
  if (k < 1 || n < 0 || sc < 0 || count < 0 || count > sc ||
      sc + n >= (1LL << 31) || rows < 32 || rows % 32 != 0 ||
      ntiles != (n > 0 ? (n + t1 - 1) / t1 : 1))
    return cudaErrorInvalidValue;
  const int smem1 = 4 * pad4((static_cast<int>(t1) + 1) * k + 3);
  const int smem2 = 4 * (pad4(rows * k + 3) + 2 * (rows / 32));
  if (smem1 > kSmemMax || smem2 > kSmemMax) return cudaErrorInvalidValue;
  uint32_t* ticket = reinterpret_cast<uint32_t*>(ws + 1);
  uint64_t* status = ws + 2;
  int2* pr = reinterpret_cast<int2*>(pairs);
  cudaError_t err;
#define JMC_NEW(I)                                                          \
  launch_new<I>(smem1, ntiles, stream, skeys, found, sidx, lb, nk_sidx, pr, \
                scalars, ticket, status, count, n, sc, k)
  switch (items) {
    case 8: err = JMC_NEW(8); break;
    case 4: err = JMC_NEW(4); break;
    case 2: err = JMC_NEW(2); break;
    case 1: err = JMC_NEW(1); break;
    default: return cudaErrorInvalidValue;
  }
#undef JMC_NEW
  if (err != cudaSuccess) return fail(err);
  if (smem2 > kSmemDefault) {
    err = cudaFuncSetAttribute(merge_rows_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem2);
    if (err != cudaSuccess) return fail(err);
  }
  const int64_t ntiles2 = (sc + rows - 1) / rows;
  int64_t grid = ntiles2;
  const int64_t zero_blocks = (n + 4LL * kThreads - 1) / (4LL * kThreads);
  if (grid < zero_blocks) grid = zero_blocks;
  if (grid < 1) grid = 1;
  merge_rows_kernel<<<static_cast<unsigned>(grid), kThreads, smem2,
                      stream>>>(seen, skeys, pr, scalars, seen2, nk_sidx,
                                status, count, n, sc, k, rows, ntiles,
                                ntiles2);
  return cudaGetLastError();
}
