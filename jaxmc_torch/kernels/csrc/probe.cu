// K3 seen_probe: lexicographic lower bound of each query key in the
// sorted seen prefix, and exact membership.
//
// Replaces: jaxmc/backend/bfs.py:142 _lower_bound and :199 _seen_probe
// (a fixed-trip lax.fori_loop of gathers and selects that XLA ran over
// the whole query block, inside _rank_merge at bfs.py:334).
//
// Bound on the card: bytes, as the compulsory traffic of the queries
// (their K-1 data words, N*(K-1)*4 read; N*5 written) plus one read of
// the K-1 data words of each live seen row, count*(K-1)*4.  The searches' dependent loads are
// latency-bound in practice: each probe waits on the previous one.
//
// Design: one thread per query, plain binary search with early exit
// (at most ceil(log2 SC)+1 probes, the reference's trip count, and the
// same result), comparing the K-1 data words as signed int32 with the
// validity lane excluded, then `found` by equality at lb.  Many
// independent searches in flight per SM hide the load latency; the top
// levels of the implicit search tree stay hot in L2 across threads.
// Indices are 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void seen_probe_kernel(const int32_t* __restrict__ seen,
                                  const int32_t* __restrict__ queries,
                                  bool* __restrict__ found,
                                  int32_t* __restrict__ lb_out,
                                  int64_t count, int64_t n, int k) {
  for (int64_t q = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       q < n; q += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int32_t* qw = queries + q * k;
    int64_t lo = 0, hi = count;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      const int32_t* sw = seen + mid * k;
      int cmp = 0;  // sign of seen[mid] - query over words 1..k-1
      for (int j = 1; j < k && cmp == 0; ++j) {
        const int32_t a = sw[j], b = qw[j];
        cmp = (a < b) ? -1 : ((a > b) ? 1 : 0);
      }
      if (cmp < 0) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    bool eq = false;
    if (lo < count) {
      const int32_t* sw = seen + lo * k;
      eq = true;
      for (int j = 1; j < k; ++j) eq = eq && (sw[j] == qw[j]);
    }
    found[q] = eq;
    lb_out[q] = static_cast<int32_t>(lo);
  }
}

}  // namespace

extern "C" cudaError_t jmc_seen_probe(const int32_t* seen,
                                      const int32_t* queries, bool* found,
                                      int32_t* lb, int64_t count, int64_t n,
                                      int k, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  seen_probe_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      seen, queries, found, lb, count, n, k);
  return cudaGetLastError();
}
