// K12 oracle_probe: the preflight probe's work after its sort -- the
// rank scatter, the fixed-trip lower bound and the int32 checksum.
//
// Replaces: jaxmc/backend/oracle.py:72 `probe` (the program of
// _PROBE_SRC, run under jax.jit by the preflight oracle): after its
// stable 4-key lax.sort with a row-index payload, `out.at[perm].set(sk)`,
// a 14-step lax.fori_loop lower bound of keys[:, 0] in sk[:, 0] with
// clip(mid, 0, N-1), and `out.sum() + lo.sum()` in int32.  The sort
// before it is K18 sort_keys (sort.cu).
//
// Bound on the card: bytes.  Each row reads its 4 sorted words, its
// permutation entry and keys[i, 0], and writes its 4 words at out[perm]
// and lo: 44 bytes a row, about 0.36 MB at the probe's N = 8192 -- a
// single launch whose time is its launch latency.
//
// Design: one thread per row.  The thread scatters its row, runs the
// reference's search step for step (no lo < hi guard: a converged lo
// can pass hi exactly as the reference's does), and adds its four
// words and lo into a uint32 partial; a warp shuffle sums the warp's
// partials and lane 0 adds them into one uint32 accumulator with an
// atomic.  Sums mod 2^32 do not depend on their order, so the checksum
// is deterministic and equals the reference's wrapped int32 sum (the
// out words are a permutation of the sorted words, so each thread may
// add its own).  The searches' loads of sk[:, 0] hit L2 after the
// first few threads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void oracle_probe_kernel(const int32_t* __restrict__ sk,
                                    const int32_t* __restrict__ perm,
                                    const int32_t* __restrict__ keys,
                                    int32_t* __restrict__ out,
                                    int32_t* __restrict__ lo_out,
                                    unsigned int* __restrict__ acc,
                                    int n, int steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned int part = 0u;
  if (i < n) {
    const int32_t* row = sk + static_cast<int64_t>(i) * 4;
    const int32_t w0 = row[0], w1 = row[1], w2 = row[2], w3 = row[3];
    int32_t* dst = out + static_cast<int64_t>(perm[i]) * 4;
    dst[0] = w0;
    dst[1] = w1;
    dst[2] = w2;
    dst[3] = w3;
    const int32_t key = keys[static_cast<int64_t>(i) * 4];
    int lo = 0, hi = n;
    for (int s = 0; s < steps; ++s) {
      const int mid = (lo + hi) >> 1;  // floor: lo, hi >= 0
      const int m = mid < 0 ? 0 : (mid > n - 1 ? n - 1 : mid);
      const bool lt = sk[static_cast<int64_t>(m) * 4] < key;
      lo = lt ? mid + 1 : lo;
      hi = lt ? hi : mid;
    }
    lo_out[i] = lo;
    part = static_cast<unsigned int>(w0) + static_cast<unsigned int>(w1) +
           static_cast<unsigned int>(w2) + static_cast<unsigned int>(w3) +
           static_cast<unsigned int>(lo);
  }
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_down_sync(0xffffffffu, part, off);
  if ((threadIdx.x & 31) == 0) atomicAdd(acc, part);
}

}  // namespace

extern "C" cudaError_t jmc_oracle_probe(const int32_t* sk,
                                        const int32_t* perm,
                                        const int32_t* keys, int32_t* out,
                                        int32_t* lo, unsigned int* acc,
                                        int n, int steps,
                                        cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  const int blocks = (n + kThreads - 1) / kThreads;
  oracle_probe_kernel<<<blocks, kThreads, 0, stream>>>(sk, perm, keys, out,
                                                       lo, acc, n, steps);
  return cudaGetLastError();
}
