// K4 rank_merge: merge the sorted candidate keys that are new into the
// sorted seen table, in O(SC + N) work.
//
// Replaces: the gather, compare and scatter bodies of
// jaxmc/backend/bfs.py:285 _rank_merge (multikey=True, called from the
// level step at bfs.py:1814): the adjacent-duplicate flags, the `new`
// verdict, the cumsum compaction to nk_sidx, the scatter-add histogram
// of the new keys' lower bounds and the rank scatter into seen2.  The
// stable key sort (lax.sort) and the two prefix sums (jnp.cumsum) are
// primitives the reference leaves to the compiler; the port leaves
// them to torch.sort and torch.cumsum between the launches.  A hand
// radix sort (onesweep) and an in-kernel decoupled-lookback scan are
// later work.
//
// Bound on the card: bytes.  The live seen rows are read once
// (count*K*4) and the whole SC-row table written once (SC*K*4); every
// sorted key is read once for the duplicate check (N*K*4) with its
// `found` byte, the index and lower bound of each new key are read
// (new*8), and nk_sidx is written (N*4).
//
// Design: three launches, one thread per element.
//   a  (jmc_merge_flags)    flags[i] = valid & !found & (key != prev),
//                           and zero nk_sidx and the histogram;
//   -- npos = cumsum(flags) (torch) --
//   b  (jmc_merge_compact)  for new i, j = npos[i]-1: nk_sidx[j] = sidx,
//                           atomicAdd(hist[lb], 1);
//   -- ranks = cumsum(hist) (torch) --
//   c  (jmc_merge_scatter)  seen row i -> i + ranks[i], new key i ->
//                           lb[i] + j, and the invalid tail rows
//                           [count2, SC) -> (1, SENTINEL...).
// Launch c writes a second SC buffer (ping-pong with the table being
// read, never in place) and covers every output row exactly once, so
// nothing is pre-filled.  The new count is read on the device from
// npos[N-1]: no host synchronisation between the launches.  Indices are
// 64-bit; rows past SC are dropped (the engine grows SC so that
// count + N <= SC before every merge).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kSentinel = 0x7FFFFFFF;

inline int64_t grid_for(int64_t n, int threads) {
  int64_t b = (n + threads - 1) / threads;
  if (b < 1) b = 1;
  if (b > 65535LL * 32) b = 65535LL * 32;
  return b;
}

__global__ void merge_flags_kernel(const int32_t* __restrict__ skeys,
                                   const bool* __restrict__ found,
                                   int32_t* __restrict__ flags,
                                   int32_t* __restrict__ nk_sidx,
                                   int32_t* __restrict__ hist, int64_t n,
                                   int64_t sc, int k) {
  const int64_t total = n > sc + 1 ? n : sc + 1;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    if (i <= sc) hist[i] = 0;
    if (i >= n) continue;
    nk_sidx[i] = 0;
    const int32_t* row = skeys + i * k;
    bool neq_prev = true;
    if (i > 0) {
      const int32_t* prev = row - k;
      neq_prev = false;
      for (int j = 0; j < k; ++j) neq_prev = neq_prev || (row[j] != prev[j]);
    }
    flags[i] = (row[0] == 0 && !found[i] && neq_prev) ? 1 : 0;
  }
}

__global__ void merge_compact_kernel(const int32_t* __restrict__ flags,
                                     const int32_t* __restrict__ npos,
                                     const int32_t* __restrict__ sidx,
                                     const int32_t* __restrict__ lb,
                                     int32_t* __restrict__ nk_sidx,
                                     int32_t* __restrict__ hist, int64_t n,
                                     int64_t sc) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    if (!flags[i]) continue;
    const int64_t j = static_cast<int64_t>(npos[i]) - 1;
    nk_sidx[j] = sidx[i];
    int64_t b = lb[i];
    b = b < 0 ? 0 : (b > sc ? sc : b);
    atomicAdd(hist + b, 1);
  }
}

__global__ void merge_scatter_kernel(const int32_t* __restrict__ seen,
                                     const int32_t* __restrict__ skeys,
                                     const int32_t* __restrict__ flags,
                                     const int32_t* __restrict__ npos,
                                     const int32_t* __restrict__ lb,
                                     const int32_t* __restrict__ ranks,
                                     int32_t* __restrict__ seen2,
                                     int64_t count, int64_t n, int64_t sc,
                                     int k) {
  const int64_t new_count = n > 0 ? static_cast<int64_t>(npos[n - 1]) : 0;
  const int64_t count2 = count + new_count;
  const int64_t total = n > sc ? n : sc;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    if (i < count) {  // seen row i moves past the new keys below it
      const int64_t dst = i + ranks[i];
      if (dst < sc) {
        for (int j = 0; j < k; ++j) seen2[dst * k + j] = seen[i * k + j];
      }
    }
    if (i < n && flags[i]) {  // j-th new key lands at lb + j
      const int64_t dst = static_cast<int64_t>(lb[i]) + npos[i] - 1;
      if (dst < sc) {
        seen2[dst * k] = 0;
        for (int j = 1; j < k; ++j) seen2[dst * k + j] = skeys[i * k + j];
      }
    }
    if (i < sc && i >= count2) {  // invalid tail
      seen2[i * k] = 1;
      for (int j = 1; j < k; ++j) seen2[i * k + j] = kSentinel;
    }
  }
}

}  // namespace

extern "C" cudaError_t jmc_merge_flags(const int32_t* skeys,
                                       const bool* found, int32_t* flags,
                                       int32_t* nk_sidx, int32_t* hist,
                                       int64_t n, int64_t sc, int k,
                                       cudaStream_t stream) {
  const int threads = 256;
  const int64_t total = n > sc + 1 ? n : sc + 1;
  merge_flags_kernel<<<static_cast<unsigned>(grid_for(total, threads)),
                       threads, 0, stream>>>(skeys, found, flags, nk_sidx,
                                             hist, n, sc, k);
  return cudaGetLastError();
}

extern "C" cudaError_t jmc_merge_compact(const int32_t* flags,
                                         const int32_t* npos,
                                         const int32_t* sidx,
                                         const int32_t* lb, int32_t* nk_sidx,
                                         int32_t* hist, int64_t n,
                                         int64_t sc, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  const int threads = 256;
  merge_compact_kernel<<<static_cast<unsigned>(grid_for(n, threads)),
                         threads, 0, stream>>>(flags, npos, sidx, lb,
                                               nk_sidx, hist, n, sc);
  return cudaGetLastError();
}

extern "C" cudaError_t jmc_merge_scatter(const int32_t* seen,
                                         const int32_t* skeys,
                                         const int32_t* flags,
                                         const int32_t* npos,
                                         const int32_t* lb,
                                         const int32_t* ranks,
                                         int32_t* seen2, int64_t count,
                                         int64_t n, int64_t sc, int k,
                                         cudaStream_t stream) {
  const int threads = 256;
  const int64_t total = n > sc ? n : sc;
  if (total <= 0) return cudaSuccess;
  merge_scatter_kernel<<<static_cast<unsigned>(grid_for(total, threads)),
                         threads, 0, stream>>>(seen, skeys, flags, npos, lb,
                                               ranks, seen2, count, n, sc, k);
  return cudaGetLastError();
}
