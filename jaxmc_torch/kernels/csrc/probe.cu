// K3 seen_probe: lexicographic lower bound of each query key in the
// sorted seen prefix, and exact membership.
//
// Replaces: jaxmc/backend/bfs.py:142 _lower_bound and :199 _seen_probe
// (a fixed-trip lax.fori_loop of gathers and selects that XLA ran over
// the whole query block, inside _rank_merge at bfs.py:334).  For each
// query row: lb = the first index of seen[0:count) whose K-1 data words
// (signed int32, word 0, the validity lane, excluded) are not below the
// query's, and found = lb < count && seen[lb] == query on those words.
//
// Bound on the card: bytes, as the compulsory traffic of the queries
// (their K-1 data words, N*(K-1)*4 read; N*5 written) plus one read of
// the K-1 data words of each live seen row, count*(K-1)*4.  A search
// from the full range instead costs ceil(log2 count) dependent loads a
// query, each a 32-byte sector from L2 or HBM below the levels that stay
// on chip.
//
// Design: use the order of the queries where it is there, and need none.
// The rank sites probe sorted keys (rank_merge probes the output of its
// own sort), so the lower bounds of consecutive queries are
// non-decreasing; the POR sites probe keys in candidate order.  The
// wrapper says which (its `site`); the kernel trusts it for speed only:
// every route is right for queries in any order.
//   Tiles (the rank sites, keys of 2 to 9 words).  One block of 256
//   threads takes a tile of T = 256 * R consecutive queries, thread t
//   the R queries t*R .. t*R+R-1, R = min(8, 8,192 / (256 * (K-1))):
//   T = 2,048 for K <= 5 (the exact keys of K 3 and the fp128 keys of
//   K 5), 1,536 for K 6, 1,024 for K 8 and 9.  At K 3 a tile is 24 KB
//   of queries against two searches of the seen table: 2,048 keeps the
//   searches to 1 per 1,000 queries while the tile's data words (at
//   most 32 KB) leave room for 4 blocks on an SM.  The data words arrive
//   in shared memory by cp.async (4-byte copies, coalesced; one word of
//   padding every 32 so that thread t's rows fall in distinct banks).
//   Searches.  While the copies are in flight, warps 0 and 1 find the
//   lower bounds L of the tile's first query and R of its last in global
//   memory, 32 lanes a round probing 32 evenly spaced rows of the range
//   (a 33-ary search: 5 dependent rounds for 5.5 M rows, against 23).
//   Order check in the kernel.  Each thread reads its R queries from
//   shared memory into registers, tests its adjacent pairs and the pair
//   that ends at the next thread's first, and __syncthreads_and decides
//   for the tile.
//   Ordered tile.  Every lb lies in [L, R].  When the window seen[L ..
//   min(R, count-1)] has at most 8,192 / (K-1) rows (the same 32 KB the
//   queries used, free again once they sit in registers: 4,096 rows at
//   K 3, about 7 times the mean window at the 4-process model's widest
//   level; 2,048 rows measured slower there, PERF.md), the block stages
//   it by cp.async and each thread searches there: a binary search of
//   [L, R] for its first query, then for each next one an exponential
//   search from the previous lb (one probe when the next lb is the same
//   row), found read from the row the search ended on.  A wider window
//   is searched the same way in global memory.  A tile of equal queries
//   (the invalid SENTINEL run at the end of a sorted block) costs its
//   two searches and one probe a query.
//   Unordered tile (a tile where the data words restart): each thread
//   runs R binary searches of [0, count) in global memory in lockstep.
//   Any order (the POR sites; keys wider than 9 words): one thread a
//   query, the full search in global memory.  For keys in no order the
//   L2's sector rate bounds a search, and the L1 of an SM, which blocks
//   without shared memory leave whole, holds the top levels of every
//   search at once; the tiles measured slower there (PERF.md §6, B.5p).
//   No cross-block state: no workspace and no epoch, so K3 may be
//   captured in a CUDA graph.  Indices are 32-bit (the wrapper refuses
//   count >= 2^31); row offsets are 64-bit.
// Shared memory: the tiles 8,192 + 256 words (33 KB) a block, static;
// the one-query-a-thread kernel none.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;
// the words a tile's queries, then its window, may take in shared memory
constexpr int kBufWords = 8192;

template <int NW>
struct Geometry {
  static constexpr int kPer = kBufWords / (kThreads * NW);
  static constexpr int R = kPer > 8 ? 8 : (kPer < 1 ? 1 : kPer);
  static constexpr int T = kThreads * R;
  static constexpr int kWindowRows = kBufWords / NW;
};

// one word of padding every 32: thread t's rows t*R.. (a stride of R*NW
// words) fall in distinct banks
__device__ __forceinline__ int pad(int a) { return a + (a >> 5); }

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// sign of row - q over NW data words, signed, word by word (the row a
// pointer, or a query's words in registers); the row's words are read at
// once
template <int NW, class Row>
__device__ __forceinline__ int cmp_row(const Row& row,
                                       const int32_t (&q)[NW]) {
  int32_t r[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = row[j];
  int c = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j)
    if (c == 0 && r[j] != q[j]) c = r[j] < q[j] ? -1 : 1;
  return c;
}

// the data words of row p of a table: seen rows in global memory
// (stride K, word 0 skipped) or a window staged in shared memory
// (stride NW, first row `origin`)
struct Rows {
  const int32_t* base;
  int stride;
  int origin;
  __device__ __forceinline__ const int32_t* operator()(int p) const {
    return base + static_cast<int64_t>(p - origin) * stride;
  }
};

// lower bound of q in seen[0:count) by one warp: each round its 32 lanes
// probe 32 evenly spaced rows of the range and keep the gap between the
// last row below q and the first not below; the same result in every
// lane
template <int NW>
__device__ int warp_lower_bound(const int32_t* seen, int count,
                                const int32_t (&q)[NW]) {
  const int lane = threadIdx.x & 31;
  const Rows rows{seen + 1, NW + 1, 0};
  int lo = 0, hi = count;
  while (hi - lo > 32) {
    const int n = hi - lo;
    const int p = lo + static_cast<int>(
                           (static_cast<int64_t>(lane + 1) * n) / 33);
    const bool lt = cmp_row<NW>(rows(p), q) < 0;
    const int c = __popc(__ballot_sync(kFull, lt));
    const int below = __shfl_sync(kFull, p, c > 0 ? c - 1 : 0);
    const int above = __shfl_sync(kFull, p, c < 32 ? c : 31);
    if (c > 0) lo = below + 1;
    if (c < 32) hi = above;
  }
  const bool lt = lane < hi - lo && cmp_row<NW>(rows(lo + lane), q) < 0;
  return lo + __popc(__ballot_sync(kFull, lt));
}

// lower bounds of a thread's n sorted queries, all in [lo0, hi0]: a
// binary search for the first, an exponential search from the previous
// lb for each next; found from the comparison at lb (made by the search
// when it ended on lb, else once more)
template <int NW, int R>
__device__ __forceinline__ void sorted_search(const Rows& rows, int lo0,
                                              int hi0, int count,
                                              const int32_t (&q)[R][NW],
                                              int n, int (&lb)[R],
                                              bool (&found)[R]) {
  int prev = lo0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i < n) {
      int a = prev, b = hi0;
      int at_b = 2;  // the comparison at b, 2 while unknown
      if (i > 0) {
        for (unsigned step = 1;; step <<= 1) {
          if (step > static_cast<unsigned>(hi0 - a)) break;
          const int p = a + static_cast<int>(step) - 1;
          const int c = cmp_row<NW>(rows(p), q[i]);
          if (c >= 0) {
            b = p;
            at_b = c;
            break;
          }
          a = p + 1;
        }
      }
      while (a < b) {
        const int mid = static_cast<int>(
            (static_cast<unsigned>(a) + static_cast<unsigned>(b)) >> 1);
        const int c = cmp_row<NW>(rows(mid), q[i]);
        if (c < 0) {
          a = mid + 1;
        } else {
          b = mid;
          at_b = c;
        }
      }
      if (a < count && at_b == 2) at_b = cmp_row<NW>(rows(a), q[i]);
      lb[i] = a;
      found[i] = a < count && at_b == 0;
      prev = a;
    }
  }
}

// lower bounds of a thread's n queries in any order (a tile whose data
// words restart): R binary searches of [0, count) in lockstep
template <int NW, int R>
__device__ __forceinline__ void full_search(const int32_t* seen, int count,
                                            const int32_t (&q)[R][NW],
                                            int n, int (&lb)[R],
                                            bool (&found)[R]) {
  const Rows rows{seen + 1, NW + 1, 0};
  unsigned lo[R], hi[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    lo[i] = 0;
    hi[i] = i < n ? static_cast<unsigned>(count) : 0;
  }
  const int steps = count > 0 ? 32 - __clz(count) : 0;
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (lo[i] < hi[i]) {
        const unsigned mid = (lo[i] + hi[i]) >> 1;
        if (cmp_row<NW>(rows(static_cast<int>(mid)), q[i]) < 0) {
          lo[i] = mid + 1;
        } else {
          hi[i] = mid;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    lb[i] = static_cast<int>(lo[i]);
    found[i] = i < n && lo[i] < static_cast<unsigned>(count) &&
               cmp_row<NW>(rows(static_cast<int>(lo[i])), q[i]) == 0;
  }
}

// R consecutive int32 (lb) and bools (found) at p, q: vector stores
// where whole and aligned
template <int R>
__device__ __forceinline__ void store_out(int32_t* p, bool* f,
                                          const int (&lb)[R],
                                          const bool (&found)[R], int n) {
  if (n == R && R % 4 == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 4)
      *reinterpret_cast<int4*>(p + i) =
          make_int4(lb[i], lb[i + 1], lb[i + 2], lb[i + 3]);
  } else if (n == R && R % 2 == 0 &&
             (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 2)
      *reinterpret_cast<int2*>(p + i) = make_int2(lb[i], lb[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (i < n) p[i] = lb[i];
  }
  if (n == R && R % 4 == 0 && (reinterpret_cast<uintptr_t>(f) & 3) == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 4)
      *reinterpret_cast<uint32_t*>(f + i) =
          static_cast<uint32_t>(found[i]) |
          static_cast<uint32_t>(found[i + 1]) << 8 |
          static_cast<uint32_t>(found[i + 2]) << 16 |
          static_cast<uint32_t>(found[i + 3]) << 24;
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (i < n) f[i] = found[i];
  }
}

template <int NW>
__global__ void __launch_bounds__(kThreads)
    seen_probe_tile_kernel(const int32_t* __restrict__ seen,
                           const int32_t* __restrict__ queries,
                           bool* __restrict__ found_out,
                           int32_t* __restrict__ lb_out, int count,
                           int64_t n) {
  using G = Geometry<NW>;
  constexpr int R = G::R, T = G::T, K = NW + 1;
  __shared__ int32_t s_buf[kBufWords + kBufWords / 32];
  __shared__ int s_bound[2];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * T;
  const int nq = static_cast<int>(n - q0 < T ? n - q0 : T);
  const int32_t* qg = queries + q0 * K;
  for (int w = tid; w < nq * NW; w += kThreads) {
    const int r = w / NW;
    cp_async4(s_buf + pad(w), qg + static_cast<int64_t>(r) * K + 1 + w -
                                  r * NW);
  }
  if (warp < 2) {
    const int32_t* qr = qg + static_cast<int64_t>(warp ? nq - 1 : 0) * K + 1;
    int32_t q[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) q[j] = qr[j];
    const int b = warp_lower_bound<NW>(seen, count, q);
    if ((tid & 31) == 0) s_bound[warp] = b;
  }
  cp_async_wait_all();
  __syncthreads();
  // this thread's queries into registers, and the order of its pairs
  const int r0 = tid * R;
  const int mine = nq - r0 < 0 ? 0 : (nq - r0 < R ? nq - r0 : R);
  int32_t q[R][NW];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < NW; ++j)
      q[i][j] = i < mine ? s_buf[pad((r0 + i) * NW + j)] : 0;
  bool ok = true;
#pragma unroll
  for (int i = 1; i < R; ++i)
    if (i < mine) ok = ok && cmp_row<NW>(q[i - 1], q[i]) <= 0;
  if (mine == R && r0 + R < nq) {
    int32_t nx[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) nx[j] = s_buf[pad((r0 + R) * NW + j)];
    ok = ok && cmp_row<NW>(q[R - 1], nx) <= 0;
  }
  // also the barrier after which s_buf is free for the window
  const bool ordered = __syncthreads_and(ok);
  int lb[R];
  bool found[R];
  if (ordered) {
    const int lo = s_bound[0], hi = s_bound[1];
    const int last = hi < count ? hi : count - 1;
    const int nrows = last - lo + 1;
    if (nrows <= G::kWindowRows) {
      const int32_t* wg = seen + static_cast<int64_t>(lo) * K + 1;
      for (int w = tid; w < nrows * NW; w += kThreads) {
        const int r = w / NW;
        cp_async4(s_buf + w, wg + static_cast<int64_t>(r) * K + w - r * NW);
      }
      cp_async_wait_all();
      __syncthreads();
      sorted_search<NW, R>(Rows{s_buf, NW, lo}, lo, hi, count, q, mine, lb,
                           found);
    } else {
      sorted_search<NW, R>(Rows{seen + 1, K, 0}, lo, hi, count, q, mine, lb,
                           found);
    }
  } else {
    full_search<NW, R>(seen, count, q, mine, lb, found);
  }
  if (mine > 0) store_out<R>(lb_out + q0 + r0, found_out + q0 + r0, lb, found,
                             mine);
}

// keys in any order (the POR sites) and keys wider than 9 words: one
// thread a query, the full binary search in global memory, a word past
// the first that differs not read; every block on an SM shares its L1,
// which holds the top levels of the search (the tiles' shared memory
// would take that room)
__global__ void seen_probe_any_kernel(const int32_t* __restrict__ seen,
                                       const int32_t* __restrict__ queries,
                                       bool* __restrict__ found,
                                       int32_t* __restrict__ lb_out,
                                       int count, int64_t n, int k) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= n) return;
  const int32_t* qw = queries + q * k;
  unsigned lo = 0, hi = static_cast<unsigned>(count);
  while (lo < hi) {
    const unsigned mid = (lo + hi) >> 1;
    const int32_t* sw = seen + static_cast<int64_t>(mid) * k;
    int cmp = 0;
    for (int j = 1; j < k && cmp == 0; ++j)
      cmp = sw[j] < qw[j] ? -1 : (sw[j] > qw[j] ? 1 : 0);
    if (cmp < 0) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  bool eq = false;
  if (lo < static_cast<unsigned>(count)) {
    const int32_t* sw = seen + static_cast<int64_t>(lo) * k;
    eq = true;
    for (int j = 1; j < k; ++j) eq = eq && sw[j] == qw[j];
  }
  found[q] = eq;
  lb_out[q] = static_cast<int32_t>(lo);
}

template <int NW>
cudaError_t launch_tiles(const int32_t* seen, const int32_t* queries,
                         bool* found, int32_t* lb, int count, int64_t n,
                         cudaStream_t stream) {
  const int64_t tiles = (n + Geometry<NW>::T - 1) / Geometry<NW>::T;
  seen_probe_tile_kernel<NW><<<static_cast<unsigned>(tiles), kThreads, 0,
                               stream>>>(seen, queries, found, lb, count, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t jmc_seen_probe(const int32_t* seen,
                                      const int32_t* queries, bool* found,
                                      int32_t* lb, int64_t count, int64_t n,
                                      int k, int sorted,
                                      cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  const int c = static_cast<int>(count);
  if (sorted) {
    switch (k - 1) {
      case 1: return launch_tiles<1>(seen, queries, found, lb, c, n, stream);
      case 2: return launch_tiles<2>(seen, queries, found, lb, c, n, stream);
      case 3: return launch_tiles<3>(seen, queries, found, lb, c, n, stream);
      case 4: return launch_tiles<4>(seen, queries, found, lb, c, n, stream);
      case 5: return launch_tiles<5>(seen, queries, found, lb, c, n, stream);
      case 6: return launch_tiles<6>(seen, queries, found, lb, c, n, stream);
      case 7: return launch_tiles<7>(seen, queries, found, lb, c, n, stream);
      case 8: return launch_tiles<8>(seen, queries, found, lb, c, n, stream);
      default: break;
    }
  }
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  seen_probe_any_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(seen, queries, found, lb, c, n, k);
  return cudaGetLastError();
}
