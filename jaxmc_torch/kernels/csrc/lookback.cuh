// The tile status words of the single-pass stable compactions (K8
// resident_compact, K11 fullsort_dedup): Merrill & Garland, "Single-pass
// Parallel Prefix Scan with Decoupled Look-back" (NVIDIA, 2016).
//
// One 64-bit word per tile and count: bits 63-34 the call's epoch, 33-32
// the state (invalid, aggregate, inclusive prefix), 31-0 the count (below
// 2^31).  Each call takes a new epoch from its wrapper, so a word left by
// an earlier call reads as invalid and nothing is cleared between calls.
// Words are read and written with relaxed gpu-scope accesses and need no
// fence: the count a tile publishes is the whole of its word.

#pragma once

#include <cstdint>

namespace jmc_lb {

constexpr uint32_t kInvalid = 0;
constexpr uint32_t kAggregate = 1;
constexpr uint32_t kInclusive = 2;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint64_t load(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ uint64_t word(uint32_t epoch, uint32_t state,
                                         uint32_t payload) {
  return (static_cast<uint64_t>((epoch << 2) | state) << 32) | payload;
}

// the state of a word read during call `epoch`
__device__ __forceinline__ uint32_t state(uint64_t w, uint32_t epoch) {
  const uint32_t hi = static_cast<uint32_t>(w >> 32);
  return (hi >> 2) == epoch ? (hi & 3u) : kInvalid;
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// One warp's look-back for tile `tile` whose own count is agg: publish
// the aggregate, sum the earlier tiles' words 32 at a time (lane l reads
// tile end - 1 - l) back to the nearest inclusive prefix, publish this
// tile's inclusive prefix.  Returns the exclusive prefix (in every lane).
__device__ __forceinline__ uint32_t look_back(uint64_t* status, int tile,
                                              uint32_t epoch, uint32_t agg) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) store(status, word(epoch, kInclusive, agg));
    return 0;
  }
  if (lane == 0) store(status + tile, word(epoch, kAggregate, agg));
  uint32_t excl = 0;
  for (int end = tile;; end -= 32) {
    const int p = end - 1 - lane;
    uint64_t w = p >= 0 ? load(status + p) : word(epoch, kInclusive, 0);
    uint32_t st = state(w, epoch);
    while (st == kInvalid) {
      __nanosleep(20);
      w = load(status + p);
      st = state(w, epoch);
    }
    const uint32_t sum = static_cast<uint32_t>(w);
    const unsigned inc = __ballot_sync(kFull, st == kInclusive);
    if (inc) {
      const int lead = __ffs(inc) - 1;
      excl += warp_sum(lane <= lead ? sum : 0u);
      break;
    }
    excl += warp_sum(sum);
  }
  if (lane == 0) store(status + tile, word(epoch, kInclusive, excl + agg));
  return excl;
}

// the block's tile: a ticket from the counter, so that every tile with a
// smaller ticket is already resident or finished and a look-back never
// waits on a tile that has not started; the tile that takes the last
// ticket sets the counter back to 0 for the next call
__device__ __forceinline__ int take_ticket(uint32_t* ticket, int ntiles,
                                           int* s_tile) {
  if (threadIdx.x == 0) {
    const int t = static_cast<int>(atomicAdd(ticket, 1u));
    if (t == ntiles - 1) atomicExch(ticket, 0u);
    *s_tile = t;
  }
  __syncthreads();
  return *s_tile;
}

}  // namespace jmc_lb
