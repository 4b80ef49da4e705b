// K6 por_mask: the device persistent-set filter of one level.
//
// Replaces: jaxmc/backend/bfs.py:216 _por_mask (a one-hot
// [n_arms, A] @ [A, FC] product for each frontier slot's enabled and
// already-seen successor counts per arm, an argmax over the eligible
// arms and the keep mask, fused by XLA into the level step at
// bfs.py:1795).
//
// Per frontier slot f: an arm is eligible when it is por-safe, has an
// enabled successor at f and no successor that the pre-level seen table
// already holds; the lowest-indexed eligible arm (the reference's argmax
// over arms, not instance order) keeps its candidates and every other
// arm's candidates at f are masked.  Slots without an eligible arm keep
// full expansion.  n_ample counts the slots reduced, n_expanded the
// slots with any enabled candidate, masked the candidates dropped.
//
// Bound on the card: bytes.  found and cvalid are read once
// (2*A*FC bytes), keep written once (A*FC); inst_arm and arm_safe are a
// few hundred bytes.  Work is a few operations per candidate.
//
// Design: one thread per frontier slot.  The thread walks the A instance
// rows twice; at each step the warp reads cvalid[a*FC + f] and
// found[a*FC + f] for 32 consecutive f (coalesced) and the same
// inst_arm[a] (a broadcast).  The per-arm counts only matter as
// "enabled > 0" and "old == 0", so they are two bit sets over the arms
// (at most kMaxArms, checked by the wrapper); the safe set sits in
// shared memory.  The three counters are block sums (warp shuffles,
// then shared memory) and one atomicAdd each per block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWords = 16;  // kMaxArms = 1024 arms
constexpr int kThreads = 256;

__device__ inline unsigned long long warp_sum(unsigned long long v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, d);
  return v;
}

__global__ void por_mask_kernel(const bool* __restrict__ found,
                                const bool* __restrict__ cvalid,
                                const int32_t* __restrict__ inst_arm,
                                const bool* __restrict__ arm_safe,
                                bool* __restrict__ keep,
                                unsigned long long* __restrict__ counts,
                                int a_rows, int64_t fc, int n_arms) {
  __shared__ unsigned long long safe[kMaxWords];
  __shared__ unsigned long long part[3][kThreads / 32];
  const int nw = (n_arms + 63) / 64;
  if (threadIdx.x < kMaxWords) {
    unsigned long long m = 0;
    for (int b = 0; b < 64; ++b) {
      const int arm = threadIdx.x * 64 + b;
      if (arm < n_arms && arm_safe[arm]) m |= 1ull << b;
    }
    safe[threadIdx.x] = m;
  }
  __syncthreads();
  unsigned long long n_ample = 0, n_exp = 0, n_masked = 0;
  const int64_t f = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (f < fc) {
    unsigned long long en[kMaxWords], old[kMaxWords];
    for (int i = 0; i < nw; ++i) en[i] = old[i] = 0;
    bool slot_en = false;
    for (int a = 0; a < a_rows; ++a) {
      const int64_t c = a * fc + f;
      if (!cvalid[c]) continue;
      const int arm = inst_arm[a];
      en[arm >> 6] |= 1ull << (arm & 63);
      if (found[c]) old[arm >> 6] |= 1ull << (arm & 63);
      slot_en = true;
    }
    int chosen = -1;
    for (int i = 0; i < nw && chosen < 0; ++i) {
      const unsigned long long m = safe[i] & en[i] & ~old[i];
      if (m) chosen = i * 64 + __ffsll(static_cast<long long>(m)) - 1;
    }
    const bool has = chosen >= 0;
    for (int a = 0; a < a_rows; ++a) {
      const int64_t c = a * fc + f;
      const bool cv = cvalid[c];
      const bool k = cv && (!has || inst_arm[a] == chosen);
      keep[c] = k;
      n_masked += (cv && !k) ? 1 : 0;
    }
    n_ample = (has && slot_en) ? 1 : 0;
    n_exp = slot_en ? 1 : 0;
  }
  const unsigned long long s0 = warp_sum(n_ample);
  const unsigned long long s1 = warp_sum(n_exp);
  const unsigned long long s2 = warp_sum(n_masked);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) {
    part[0][wid] = s0;
    part[1][wid] = s1;
    part[2][wid] = s2;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    unsigned long long s = 0;
    for (int i = 0; i < kThreads / 32; ++i) s += part[threadIdx.x][i];
    if (s) atomicAdd(counts + threadIdx.x, s);
  }
}

}  // namespace

extern "C" int jmc_por_max_arms() { return kMaxWords * 64; }

extern "C" cudaError_t jmc_por_mask(const bool* found, const bool* cvalid,
                                    const int32_t* inst_arm,
                                    const bool* arm_safe, bool* keep,
                                    unsigned long long* counts, int a_rows,
                                    int64_t fc, int n_arms,
                                    cudaStream_t stream) {
  cudaError_t err =
      cudaMemsetAsync(counts, 0, 3 * sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return err;
  if (fc <= 0) return cudaGetLastError();
  if (n_arms > kMaxWords * 64) return cudaErrorInvalidValue;
  const int64_t blocks = (fc + kThreads - 1) / kThreads;
  por_mask_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      found, cvalid, inst_arm, arm_safe, keep, counts, a_rows, fc, n_arms);
  return cudaGetLastError();
}
