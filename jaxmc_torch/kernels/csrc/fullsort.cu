// K11 fullsort_dedup: the dedup and the two stable compactions of the
// level engine's full-sort step, after its sort.
//
// Replaces: jaxmc/backend/bfs.py:1820-1851, the JAXMC_LEVEL_RANKMERGE=0
// branch of _get_step's step: after the stable [SC+C, K+1]-key sort of
// the seen table and the candidates (lax.sort, outside any Pallas
// kernel; the port sorts with its LSD chain of torch.sort), the
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
// Design, as K8 and K10: three launches, nothing atomic, every output
// written by one thread, so the result is the same on every run.
//   a  (jmc_fullsort_count)    one thread per row: per-block counts of
//                              new and keep (__syncthreads_count);
//   b  (jmc_fullsort_scan)     one block: exclusive scans of both block
//                              counts, and the two totals;
//   c  (jmc_fullsort_scatter)  one thread per row: its rank among the
//                              new (or kept) rows of its block from warp
//                              ballots, plus the block's offset, is its
//                              slot.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;

struct Flags {
  bool is_new;
  bool keep;
};

__device__ __forceinline__ Flags row_flags(const int32_t* __restrict__ skeys,
                                           const int32_t* __restrict__ sflag,
                                           int64_t i, int k) {
  const int32_t* row = skeys + i * k;
  const bool rvalid = row[0] == 0;
  bool neq_prev = i == 0;
  if (!neq_prev) {
    const int32_t* prev = row - k;
    for (int j = 0; j < k && !neq_prev; ++j) neq_prev = row[j] != prev[j];
  }
  const bool cand = sflag[i] != 0;
  Flags f;
  f.is_new = cand && rvalid && neq_prev;
  f.keep = (!cand && rvalid) || f.is_new;
  return f;
}

__global__ void fullsort_count_kernel(const int32_t* __restrict__ skeys,
                                      const int32_t* __restrict__ sflag,
                                      int32_t* __restrict__ bnew,
                                      int32_t* __restrict__ bkeep, int64_t n,
                                      int k) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  Flags f{false, false};
  if (i < n) f = row_flags(skeys, sflag, i, k);
  const int32_t cn = __syncthreads_count(f.is_new);
  const int32_t ck = __syncthreads_count(f.keep);
  if (threadIdx.x == 0) {
    bnew[blockIdx.x] = cn;
    bkeep[blockIdx.x] = ck;
  }
}

// exclusive scan of one block-count array by one block; returns the total
__device__ int64_t block_scan(const int32_t* __restrict__ cnt,
                              int64_t* __restrict__ off, int32_t nb,
                              int64_t* s_sum) {
  const int t = threadIdx.x;
  const int32_t per = (nb + kScanThreads - 1) / kScanThreads;
  const int32_t lo = min(nb, t * per), hi = min(nb, lo + per);
  int64_t sum = 0;
  for (int32_t j = lo; j < hi; ++j) sum += cnt[j];
  // inclusive Hillis-Steele scan of the per-thread sums
  s_sum[t] = sum;
  __syncthreads();
  for (int o = 1; o < kScanThreads; o <<= 1) {
    const int64_t add = t >= o ? s_sum[t - o] : 0;
    __syncthreads();
    s_sum[t] += add;
    __syncthreads();
  }
  int64_t run = s_sum[t] - sum;  // exclusive prefix of this segment
  for (int32_t j = lo; j < hi; ++j) {
    off[j] = run;
    run += cnt[j];
  }
  const int64_t total = s_sum[kScanThreads - 1];
  __syncthreads();
  return total;
}

__global__ void fullsort_scan_kernel(const int32_t* __restrict__ bnew,
                                     const int32_t* __restrict__ bkeep,
                                     int64_t* __restrict__ onew,
                                     int64_t* __restrict__ okeep,
                                     int64_t* __restrict__ counts,
                                     int32_t nb) {
  __shared__ int64_t s_sum[kScanThreads];
  const int64_t tn = block_scan(bnew, onew, nb, s_sum);
  const int64_t tk = block_scan(bkeep, okeep, nb, s_sum);
  if (threadIdx.x == 0) {
    counts[0] = tn;
    counts[1] = tk;
  }
}

__global__ void fullsort_scatter_kernel(const int32_t* __restrict__ skeys,
                                        const int32_t* __restrict__ sflag,
                                        const int32_t* __restrict__ perm,
                                        const int64_t* __restrict__ onew,
                                        const int64_t* __restrict__ okeep,
                                        int32_t* __restrict__ new_cidx,
                                        int32_t* __restrict__ seen2,
                                        int64_t n, int k, int64_t sc,
                                        int64_t c) {
  __shared__ int32_t s_new[kWarps], s_keep[kWarps];
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  Flags f{false, false};
  if (i < n) f = row_flags(skeys, sflag, i, k);
  const unsigned bn = __ballot_sync(0xFFFFFFFFu, f.is_new);
  const unsigned bk = __ballot_sync(0xFFFFFFFFu, f.keep);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_new[warp] = __popc(bn);
    s_keep[warp] = __popc(bk);
  }
  __syncthreads();
  if (!f.keep) return;  // a new row is always kept
  const unsigned below = (1u << lane) - 1u;
  int64_t pk = okeep[blockIdx.x] + __popc(bk & below);
  for (int w = 0; w < warp; ++w) pk += s_keep[w];
  if (pk < sc) {
    const int32_t* src = skeys + i * k;
    int32_t* dst = seen2 + pk * k;
    for (int j = 0; j < k; ++j) dst[j] = src[j];
  }
  if (f.is_new) {
    int64_t pn = onew[blockIdx.x] + __popc(bn & below);
    for (int w = 0; w < warp; ++w) pn += s_new[w];
    if (pn < c) new_cidx[pn] = static_cast<int32_t>(perm[i] - sc);
  }
}

inline int32_t blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int32_t>(b < 1 ? 1 : b);
}

}  // namespace

extern "C" int jmc_fullsort_threads() { return kThreads; }

extern "C" cudaError_t jmc_fullsort_count(const int32_t* skeys,
                                          const int32_t* sflag, int32_t* bnew,
                                          int32_t* bkeep, int64_t n, int k,
                                          cudaStream_t stream) {
  fullsort_count_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      skeys, sflag, bnew, bkeep, n, k);
  return cudaGetLastError();
}

extern "C" cudaError_t jmc_fullsort_scan(const int32_t* bnew,
                                         const int32_t* bkeep, int64_t* onew,
                                         int64_t* okeep, int64_t* counts,
                                         int32_t nb, cudaStream_t stream) {
  fullsort_scan_kernel<<<1, kScanThreads, 0, stream>>>(bnew, bkeep, onew,
                                                       okeep, counts, nb);
  return cudaGetLastError();
}

extern "C" cudaError_t jmc_fullsort_scatter(
    const int32_t* skeys, const int32_t* sflag, const int32_t* perm,
    const int64_t* onew, const int64_t* okeep, int32_t* new_cidx,
    int32_t* seen2, int64_t n, int k, int64_t sc, int64_t c,
    cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  fullsort_scatter_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      skeys, sflag, perm, onew, okeep, new_cidx, seen2, n, k, sc, c);
  return cudaGetLastError();
}
