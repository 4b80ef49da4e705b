// The tile status words of the single-pass stable compactions (K7
// hstep_epilogue, K8 resident_compact, K11 fullsort_dedup): Merrill &
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back"
// (NVIDIA, 2016); and the bool-mask tile that K7 and K8 share (16
// entries a thread, a block scan of their counts, the set entries staged
// in shared memory).
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

// The compaction tile of K7 and K8: entries a thread (one 16-byte load
// of a bool mask), threads a tile and a tile (chosen by a sweep on the
// card, PERF.md)
constexpr int kItems = 16;
constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kTile = kTileThreads * kItems;
// "no index": the first-index reductions take the maximum of kNone - i
constexpr int32_t kNone = 0x7FFFFFFF;

__device__ __forceinline__ int32_t warp_max(int32_t v) {
  for (int o = 16; o > 0; o >>= 1)
    v = max(v, __shfl_down_sync(kFull, v, o));
  return v;
}

// bit k set when byte k of p[0..n) is nonzero: one 16-byte load when the
// thread's entries are whole and aligned
__device__ __forceinline__ uint32_t load_bits(const bool* p, int n) {
  uint32_t b = 0;
  if (n == kItems && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < kItems / 16; ++q) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[q];
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if ((w[k >> 2] >> (8 * (k & 3))) & 0xFFu) b |= 1u << (16 * q + k);
    }
    return b;
  }
  for (int k = 0; k < n; ++k)
    if (p[k]) b |= 1u << k;
  return b;
}

__device__ __forceinline__ uint32_t low_bits(int n) {
  return n >= 32 ? 0xFFFFFFFFu : (1u << n) - 1u;
}

// bit k set when slot (i0 + k) % ch is below flim: one modulo a thread,
// then the slot walks
__device__ __forceinline__ uint32_t slot_bits(int64_t i0, int n, int32_t ch,
                                              int32_t flim) {
  if (flim >= ch) return low_bits(n);
  int32_t f = static_cast<int32_t>(i0 % ch);
  uint32_t b = 0;
  for (int k = 0; k < n; ++k) {
    if (f < flim) b |= 1u << k;
    if (++f == ch) f = 0;
  }
  return b;
}

// the thread's entries of tile `tile`: its first flat index, their
// number below C and the bitmap of the set ones
struct Entries {
  int64_t i0;
  int n;
  uint32_t fv;
  uint32_t set;
};

__device__ __forceinline__ Entries tile_entries(const bool* mask, int tile,
                                                int64_t c, int32_t ch,
                                                int32_t flim) {
  Entries e;
  e.i0 = static_cast<int64_t>(tile) * kTile +
         static_cast<int64_t>(threadIdx.x) * kItems;
  const int64_t left = c - e.i0;
  e.n = left <= 0 ? 0 : (left >= kItems ? kItems : static_cast<int>(left));
  e.fv = e.n ? slot_bits(e.i0, e.n, ch, flim) : 0u;
  e.set = e.fv ? load_bits(mask + e.i0, e.n) & e.fv : 0u;
  return e;
}

// exclusive block scan of one count a thread (s_warp: kTileWarps words, free
// on entry); *total is the block's sum
__device__ __forceinline__ int block_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  int before = 0, sum = 0;
  for (int w = 0; w < kTileWarps; ++w) {
    const int s = s_warp[w];
    if (w < warp) before += s;
    sum += s;
  }
  *total = sum;
  return before + x - v;
}

// stage the flat indices of the bits of b at s_idx[r], r from rank
__device__ __forceinline__ void stage(int32_t* s_idx, int rank, uint32_t b,
                                      int64_t i0) {
  while (b) {
    const int k = __ffs(b) - 1;
    b &= b - 1;
    s_idx[rank++] = static_cast<int32_t>(i0 + k);
  }
}

// the verdict partials of a thread's grid entries (those with f < flim,
// bits e.fv): the largest ov (identity 0) into *r_ov, and kNone - the
// first index whose aok is false (identity 0) into *r_ab
__device__ __forceinline__ void verdict_partials(const Entries& e,
                                                 const bool* aok,
                                                 const int32_t* ov,
                                                 int32_t* r_ov,
                                                 int32_t* r_ab) {
  if (!e.fv) return;
  const uint32_t bad = e.fv & ~load_bits(aok + e.i0, e.n);
  if (bad) *r_ab = kNone - static_cast<int32_t>(e.i0 + __ffs(bad) - 1);
  const int32_t* o = ov + e.i0;
  int32_t m = *r_ov;
  if (e.n == kItems && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      const int4 v = reinterpret_cast<const int4*>(o)[q];
      const int32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if ((e.fv >> (4 * q + u)) & 1u) m = max(m, w[u]);
    }
  } else {
    for (int k = 0; k < e.n; ++k)
      if ((e.fv >> k) & 1u) m = max(m, o[k]);
  }
  *r_ov = m;
}

}  // namespace jmc_lb
