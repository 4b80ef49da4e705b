// K10 batch_epilogue: the host-seen chunk epilogue (K7) of B batch
// members at once — each member's verdict scalars and the order-
// preserving compaction of its valid candidates, in one set of launches
// over the stacked [B, A, CH] expansion.
//
// Replaces: the epilogue half of jaxmc/backend/batch.py:99-100
// BatchDispatcher's `jit(vmap(_hstep_core))` (site batch.vstep): per
// member, the masks and reductions of jaxmc/backend/bfs.py:1938
// _hstep_core (:1959-1978) and the host reads of them in
// _run_host_seen (:3543-3637), as K7 (hstep.cu) computes them for one
// member.  The reference copies every member's whole [A*CH, ...] block
// to the host; here the host reads the [B, 6] scalars, the [B + 1]
// offsets and each member's compacted rows.
//
// Inputs: en, aok [B, A, CH] bool, ov [B, A, CH] int32, fcount [B]
// int32 (each member's chunk row count; 0 for an idle lane), keys
// [B*A*CH, 5] (validity lane, four fingerprint words), cand [B*A*CH, PW]
// packed rows, pack_ovf [B] bool (each member's K2 flag), inv_ok and
// explore [B*A*CH] bool; candidates member-major (b, a, f).
// Outputs: scalars int64 [B, 6] = per member (nv, overflow code,
// assert_any, first assert flat index a*CH+f, dead_any, first dead f);
// dead [B, CH] bool; offsets int64 [B + 1]; and flat idx (the member's
// own a*CH+f), fps [., 4], rows [., PW], inv_ok / explore, member b's
// valid candidates at [offsets[b], offsets[b+1]) in candidate order.
// Member b's part equals K7's result on its slice bit for bit.
//
// Bound on the card: bytes, as K7: en, aok and ov read once (6 bytes a
// candidate) for the frontier slots below each member's fcount, dead
// written for those slots, the valid candidates' four fingerprint words,
// PW row words and two predicate bits read and written compacted with
// their index.
//
// Design: three launches, as K7, with the member as the grid's y
// dimension:
//   a  (jmc_batch_count)    grid (nb, B), one thread per candidate (and
//                           per frontier slot for dead): per (member,
//                           block) count of valid candidates, maximum
//                           overflow code, first assert-bad index and
//                           first dead slot;
//   b  (jmc_batch_scan)     one block: for each member in turn, the
//                           exclusive scan of its block counts (offset
//                           by the members before it) and the member's
//                           reductions into its scalars — one scan over
//                           all (member, block) counts;
//   c  (jmc_batch_scatter)  grid (nb, B) again: a valid candidate's rank
//                           in its block from warp ballots, plus the
//                           block's offset, is its slot.
// Every output is written by exactly one thread; nothing is atomic or
// pre-filled.  Indices fit in int32 (the wrapper refuses B*A*CH >=
// 2^31 - 256).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int32_t kNone = 0x7FFFFFFF;

__device__ __forceinline__ int32_t warp_max(int32_t v) {
  for (int o = 16; o > 0; o >>= 1)
    v = max(v, __shfl_down_sync(0xFFFFFFFFu, v, o));
  return v;
}

__device__ __forceinline__ int32_t warp_min(int32_t v) {
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_down_sync(0xFFFFFFFFu, v, o));
  return v;
}

__global__ void batch_count_kernel(const bool* __restrict__ en,
                                   const bool* __restrict__ aok,
                                   const int32_t* __restrict__ ov,
                                   const int32_t* __restrict__ fcount,
                                   bool* __restrict__ dead,
                                   int32_t* __restrict__ bcnt,
                                   int32_t* __restrict__ bov,
                                   int32_t* __restrict__ bab,
                                   int32_t* __restrict__ bdead, int a_n,
                                   int32_t ch) {
  __shared__ int32_t s_ov[kWarps], s_ab[kWarps], s_dead[kWarps];
  const int b = blockIdx.y;
  const int64_t c = static_cast<int64_t>(a_n) * ch;
  const int64_t mbase = static_cast<int64_t>(b) * c;
  const int32_t fc = fcount[b];
  const int32_t i = blockIdx.x * kThreads + threadIdx.x;
  bool v = false;
  int32_t ovv = 0, ab = kNone, dd = kNone;
  if (i < c) {
    const int32_t f = i % ch;
    const bool fv = f < fc;
    v = fv && en[mbase + i];
    if (fv) {
      ovv = ov[mbase + i];
      if (!aok[mbase + i]) ab = i;
    }
  }
  if (i < ch) {
    // a slot past the member's row count is not dead, and its
    // candidates are not read
    bool d = i < fc;
    for (int a = 0; a < a_n && d; ++a)
      d = !en[mbase + static_cast<int64_t>(a) * ch + i];
    dead[static_cast<int64_t>(b) * ch + i] = d;
    if (d) dd = i;
  }
  const int32_t cnt = __syncthreads_count(v);
  ovv = warp_max(ovv);
  ab = warp_min(ab);
  dd = warp_min(dd);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_ov[warp] = ovv;
    s_ab[warp] = ab;
    s_dead[warp] = dd;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t m = 0, bb = kNone, e = kNone;
    for (int w = 0; w < kWarps; ++w) {
      m = max(m, s_ov[w]);
      bb = min(bb, s_ab[w]);
      e = min(e, s_dead[w]);
    }
    const int64_t slot = static_cast<int64_t>(b) * gridDim.x + blockIdx.x;
    bcnt[slot] = cnt;
    bov[slot] = m;
    bab[slot] = bb;
    bdead[slot] = e;
  }
}

__global__ void batch_scan_kernel(const int32_t* __restrict__ bcnt,
                                  const int32_t* __restrict__ bov,
                                  const int32_t* __restrict__ bab,
                                  const int32_t* __restrict__ bdead,
                                  const bool* __restrict__ pack_ovf,
                                  int32_t* __restrict__ boff,
                                  int64_t* __restrict__ scalars,
                                  int64_t* __restrict__ offsets, int n_mem,
                                  int32_t nb, int32_t ov_pack) {
  __shared__ int32_t s_sum[kScanThreads];
  __shared__ int32_t s_ov[kScanThreads / 32], s_ab[kScanThreads / 32],
      s_dead[kScanThreads / 32];
  const int t = threadIdx.x;
  const int32_t per = (nb + kScanThreads - 1) / kScanThreads;
  const int32_t lo = min(nb, t * per), hi = min(nb, lo + per);
  int32_t base = 0;  // the valid candidates of the members before b
  for (int b = 0; b < n_mem; ++b) {
    const int64_t m0 = static_cast<int64_t>(b) * nb;
    int32_t sum = 0, m = 0, ab = kNone, dd = kNone;
    for (int32_t j = lo; j < hi; ++j) {
      sum += bcnt[m0 + j];
      m = max(m, bov[m0 + j]);
      ab = min(ab, bab[m0 + j]);
      dd = min(dd, bdead[m0 + j]);
    }
    // inclusive Hillis-Steele scan of the per-thread sums
    s_sum[t] = sum;
    __syncthreads();
    for (int o = 1; o < kScanThreads; o <<= 1) {
      const int32_t add = t >= o ? s_sum[t - o] : 0;
      __syncthreads();
      s_sum[t] += add;
      __syncthreads();
    }
    int32_t run = base + s_sum[t] - sum;  // exclusive prefix, global
    for (int32_t j = lo; j < hi; ++j) {
      boff[m0 + j] = run;
      run += bcnt[m0 + j];
    }
    m = warp_max(m);
    ab = warp_min(ab);
    dd = warp_min(dd);
    if ((t & 31) == 0) {
      s_ov[t >> 5] = m;
      s_ab[t >> 5] = ab;
      s_dead[t >> 5] = dd;
    }
    __syncthreads();
    const int32_t total = s_sum[kScanThreads - 1];
    if (t == 0) {
      int32_t mm = 0, bb = kNone, ee = kNone;
      for (int w = 0; w < kScanThreads / 32; ++w) {
        mm = max(mm, s_ov[w]);
        bb = min(bb, s_ab[w]);
        ee = min(ee, s_dead[w]);
      }
      // kernel overflow codes outrank the member's pack guard
      const int32_t code = mm != 0 ? mm : (pack_ovf[b] ? ov_pack : 0);
      int64_t* sc = scalars + static_cast<int64_t>(b) * 6;
      sc[0] = total;
      sc[1] = code;
      sc[2] = bb != kNone;
      sc[3] = bb != kNone ? bb : 0;
      sc[4] = ee != kNone;
      sc[5] = ee != kNone ? ee : 0;
      offsets[b] = base;
    }
    base += total;
    // the shared arrays are rewritten by the next member
    __syncthreads();
  }
  if (t == 0) offsets[n_mem] = base;
}

__global__ void batch_scatter_kernel(
    const bool* __restrict__ en, const int32_t* __restrict__ fcount,
    const int32_t* __restrict__ keys, const int32_t* __restrict__ cand,
    const bool* __restrict__ inv_ok, const bool* __restrict__ explore,
    const int32_t* __restrict__ boff, int32_t* __restrict__ idx,
    int32_t* __restrict__ fps, int32_t* __restrict__ rows,
    bool* __restrict__ inv_out, bool* __restrict__ exp_out, int a_n,
    int32_t ch, int pw) {
  __shared__ int32_t s_warp[kWarps];
  const int b = blockIdx.y;
  const int64_t c = static_cast<int64_t>(a_n) * ch;
  const int64_t mbase = static_cast<int64_t>(b) * c;
  const int32_t i = blockIdx.x * kThreads + threadIdx.x;
  const bool v = i < c && (i % ch) < fcount[b] && en[mbase + i];
  const unsigned ball = __ballot_sync(0xFFFFFFFFu, v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_warp[warp] = __popc(ball);
  __syncthreads();
  if (!v) return;
  int32_t pos = boff[static_cast<int64_t>(b) * gridDim.x + blockIdx.x] +
                __popc(ball & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) pos += s_warp[w];
  idx[pos] = i;
  const int64_t src = mbase + i;
  const int64_t dst = static_cast<int64_t>(pos);
  for (int j = 0; j < 4; ++j) fps[dst * 4 + j] = keys[src * 5 + 1 + j];
  for (int j = 0; j < pw; ++j) rows[dst * pw + j] = cand[src * pw + j];
  inv_out[dst] = inv_ok[src];
  exp_out[dst] = explore[src];
}

inline int32_t blocks_for(int64_t c, int32_t ch) {
  const int64_t n = c > ch ? c : ch;
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int32_t>(b < 1 ? 1 : b);
}

}  // namespace

extern "C" int jmc_batch_threads() { return kThreads; }

extern "C" cudaError_t jmc_batch_count(const bool* en, const bool* aok,
                                       const int32_t* ov,
                                       const int32_t* fcount, bool* dead,
                                       int32_t* bcnt, int32_t* bov,
                                       int32_t* bab, int32_t* bdead,
                                       int n_mem, int a_n, int32_t ch,
                                       cudaStream_t stream) {
  if (n_mem <= 0) return cudaSuccess;
  const int32_t nb = blocks_for(static_cast<int64_t>(a_n) * ch, ch);
  batch_count_kernel<<<dim3(nb, n_mem), kThreads, 0, stream>>>(
      en, aok, ov, fcount, dead, bcnt, bov, bab, bdead, a_n, ch);
  return cudaGetLastError();
}

extern "C" cudaError_t jmc_batch_scan(const int32_t* bcnt,
                                      const int32_t* bov, const int32_t* bab,
                                      const int32_t* bdead,
                                      const bool* pack_ovf, int32_t* boff,
                                      int64_t* scalars, int64_t* offsets,
                                      int n_mem, int32_t nb, int32_t ov_pack,
                                      cudaStream_t stream) {
  batch_scan_kernel<<<1, kScanThreads, 0, stream>>>(
      bcnt, bov, bab, bdead, pack_ovf, boff, scalars, offsets, n_mem, nb,
      ov_pack);
  return cudaGetLastError();
}

extern "C" cudaError_t jmc_batch_scatter(
    const bool* en, const int32_t* fcount, const int32_t* keys,
    const int32_t* cand, const bool* inv_ok, const bool* explore,
    const int32_t* boff, int32_t* idx, int32_t* fps, int32_t* rows,
    bool* inv_out, bool* exp_out, int n_mem, int a_n, int32_t ch, int pw,
    cudaStream_t stream) {
  const int64_t c = static_cast<int64_t>(a_n) * ch;
  if (c <= 0 || n_mem <= 0) return cudaSuccess;
  const int32_t nb = blocks_for(c, ch);
  batch_scatter_kernel<<<dim3(nb, n_mem), kThreads, 0, stream>>>(
      en, fcount, keys, cand, inv_ok, explore, boff, idx, fps, rows,
      inv_out, exp_out, a_n, ch, pw);
  return cudaGetLastError();
}
