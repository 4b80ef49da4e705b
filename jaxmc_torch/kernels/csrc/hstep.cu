// K7 hstep_epilogue: the host-seen chunk step's verdict scalars and the
// order-preserving compaction of its valid candidates, in one pass over
// the chunk's expansion.
//
// Replaces: the masks and reductions of jaxmc/backend/bfs.py:1938
// _hstep_core (:1959-1966 valid, assert_bad, overflow, dead, gen;
// :1976-1978 the overflow code with OV_PACK) and the host work that
// reads them in _run_host_seen (:3543-3637): np.argmax over the assert
// and dead masks, np.nonzero(cvalid), keys[valid_idx][:, 1:] and
// _take_rows_fast(cand, new_idx).  The reference copies the whole
// [A*CH, ...] block to the host; here the host reads one small scalar
// vector and the nv compacted rows.
//
// Inputs: en, aok [A, CH] bool, ov [A, CH] int32, the chunk's row count
// fcount, keys [A*CH, 5] (validity lane, four fingerprint words), cand
// [A*CH, PW] packed rows, K2's pack-overflow flag, and the predicate
// bits inv_ok and explore [A*CH] bool.
// Outputs: scalars int64[6] = (nv, overflow code, assert_any, first
// assert flat index a*CH+f, dead_any, first dead f); dead [CH] bool; the
// first nv entries of idx [C] int32, fps [C, 4], rows [C, PW] and
// inv_ok / explore [C] bool, in candidate order a*CH + f.
//
// Bound on the card: bytes.  en, aok and ov are read once (6 bytes a
// candidate); only the nv valid candidates' four fingerprint words, PW
// row words and predicate bits are read, and the same written compacted
// with their index; dead is written once.
//
// Design: three launches, as K4.
//   a  (jmc_hstep_count)    one thread per candidate (and per frontier
//                           slot for dead): per-block count of valid
//                           candidates (__syncthreads_count), maximum
//                           overflow code, first assert-bad index and
//                           first dead slot, written per block;
//   b  (jmc_hstep_scan)     one block: exclusive scan of the block
//                           counts into block offsets, and the
//                           reductions of a into the scalar vector;
//   c  (jmc_hstep_scatter)  one thread per candidate again: the rank of
//                           a valid candidate within its block from warp
//                           ballots, plus the block offset, is its slot.
// Launches a and c cover the same 256-candidate block per blockIdx, so
// the offsets of b line up.  Nothing is pre-filled and nothing is
// atomic: every output is written by exactly one thread, so the result
// is the same on every run.  Candidate indices fit in int32 (the
// wrapper refuses A*CH >= 2^31).

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

__global__ void hstep_count_kernel(const bool* __restrict__ en,
                                   const bool* __restrict__ aok,
                                   const int32_t* __restrict__ ov,
                                   bool* __restrict__ dead,
                                   int32_t* __restrict__ bcnt,
                                   int32_t* __restrict__ bov,
                                   int32_t* __restrict__ bab,
                                   int32_t* __restrict__ bdead, int a_n,
                                   int32_t ch, int32_t fcount) {
  __shared__ int32_t s_ov[kWarps], s_ab[kWarps], s_dead[kWarps];
  const int64_t c = static_cast<int64_t>(a_n) * ch;
  const int32_t i = blockIdx.x * kThreads + threadIdx.x;
  bool v = false;
  int32_t ovv = 0, ab = kNone, dd = kNone;
  if (i < c) {
    const int32_t f = i % ch;
    const bool fv = f < fcount;
    v = fv && en[i];
    if (fv) {
      ovv = ov[i];
      if (!aok[i]) ab = i;
    }
  }
  if (i < ch) {
    bool any = false;
    for (int a = 0; a < a_n && !any; ++a)
      any = en[static_cast<int64_t>(a) * ch + i];
    const bool d = i < fcount && !any;
    dead[i] = d;
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
    int32_t m = 0, b = kNone, e = kNone;
    for (int w = 0; w < kWarps; ++w) {
      m = max(m, s_ov[w]);
      b = min(b, s_ab[w]);
      e = min(e, s_dead[w]);
    }
    bcnt[blockIdx.x] = cnt;
    bov[blockIdx.x] = m;
    bab[blockIdx.x] = b;
    bdead[blockIdx.x] = e;
  }
}

__global__ void hstep_scan_kernel(const int32_t* __restrict__ bcnt,
                                  const int32_t* __restrict__ bov,
                                  const int32_t* __restrict__ bab,
                                  const int32_t* __restrict__ bdead,
                                  const bool* __restrict__ pack_ovf,
                                  int32_t* __restrict__ boff,
                                  int64_t* __restrict__ scalars, int32_t nb,
                                  int32_t ov_pack) {
  __shared__ int32_t s_sum[kScanThreads];
  __shared__ int32_t s_ov[kScanThreads / 32], s_ab[kScanThreads / 32],
      s_dead[kScanThreads / 32];
  const int t = threadIdx.x;
  const int32_t per = (nb + kScanThreads - 1) / kScanThreads;
  const int32_t lo = min(nb, t * per), hi = min(nb, lo + per);
  int32_t sum = 0, m = 0, ab = kNone, dd = kNone;
  for (int32_t j = lo; j < hi; ++j) {
    sum += bcnt[j];
    m = max(m, bov[j]);
    ab = min(ab, bab[j]);
    dd = min(dd, bdead[j]);
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
  int32_t run = s_sum[t] - sum;  // exclusive prefix of this segment
  for (int32_t j = lo; j < hi; ++j) {
    boff[j] = run;
    run += bcnt[j];
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
  if (t == 0) {
    int32_t mm = 0, bb = kNone, ee = kNone;
    for (int w = 0; w < kScanThreads / 32; ++w) {
      mm = max(mm, s_ov[w]);
      bb = min(bb, s_ab[w]);
      ee = min(ee, s_dead[w]);
    }
    // kernel overflow codes outrank the pack guard
    const int32_t code = mm != 0 ? mm : (*pack_ovf ? ov_pack : 0);
    scalars[0] = s_sum[kScanThreads - 1];
    scalars[1] = code;
    scalars[2] = bb != kNone;
    scalars[3] = bb != kNone ? bb : 0;
    scalars[4] = ee != kNone;
    scalars[5] = ee != kNone ? ee : 0;
  }
}

__global__ void hstep_scatter_kernel(
    const bool* __restrict__ en, const int32_t* __restrict__ keys,
    const int32_t* __restrict__ cand, const bool* __restrict__ inv_ok,
    const bool* __restrict__ explore, const int32_t* __restrict__ boff,
    int32_t* __restrict__ idx, int32_t* __restrict__ fps,
    int32_t* __restrict__ rows, bool* __restrict__ inv_out,
    bool* __restrict__ exp_out, int a_n, int32_t ch, int32_t fcount,
    int pw) {
  __shared__ int32_t s_warp[kWarps];
  const int64_t c = static_cast<int64_t>(a_n) * ch;
  const int32_t i = blockIdx.x * kThreads + threadIdx.x;
  const bool v = i < c && (i % ch) < fcount && en[i];
  const unsigned ball = __ballot_sync(0xFFFFFFFFu, v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_warp[warp] = __popc(ball);
  __syncthreads();
  if (!v) return;
  int32_t pos = boff[blockIdx.x] + __popc(ball & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) pos += s_warp[w];
  idx[pos] = i;
  const int64_t src = static_cast<int64_t>(i);
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

extern "C" int jmc_hstep_threads() { return kThreads; }

extern "C" cudaError_t jmc_hstep_count(const bool* en, const bool* aok,
                                       const int32_t* ov, bool* dead,
                                       int32_t* bcnt, int32_t* bov,
                                       int32_t* bab, int32_t* bdead, int a_n,
                                       int32_t ch, int32_t fcount,
                                       cudaStream_t stream) {
  const int32_t nb = blocks_for(static_cast<int64_t>(a_n) * ch, ch);
  hstep_count_kernel<<<nb, kThreads, 0, stream>>>(
      en, aok, ov, dead, bcnt, bov, bab, bdead, a_n, ch, fcount);
  return cudaGetLastError();
}

extern "C" cudaError_t jmc_hstep_scan(const int32_t* bcnt,
                                      const int32_t* bov, const int32_t* bab,
                                      const int32_t* bdead,
                                      const bool* pack_ovf, int32_t* boff,
                                      int64_t* scalars, int32_t nb,
                                      int32_t ov_pack, cudaStream_t stream) {
  hstep_scan_kernel<<<1, kScanThreads, 0, stream>>>(
      bcnt, bov, bab, bdead, pack_ovf, boff, scalars, nb, ov_pack);
  return cudaGetLastError();
}

extern "C" cudaError_t jmc_hstep_scatter(
    const bool* en, const int32_t* keys, const int32_t* cand,
    const bool* inv_ok, const bool* explore, const int32_t* boff,
    int32_t* idx, int32_t* fps, int32_t* rows, bool* inv_out, bool* exp_out,
    int a_n, int32_t ch, int32_t fcount, int pw, cudaStream_t stream) {
  const int64_t c = static_cast<int64_t>(a_n) * ch;
  if (c <= 0) return cudaSuccess;
  const int32_t nb = blocks_for(c, ch);
  hstep_scatter_kernel<<<nb, kThreads, 0, stream>>>(
      en, keys, cand, inv_ok, explore, boff, idx, fps, rows, inv_out,
      exp_out, a_n, ch, fcount, pw);
  return cudaGetLastError();
}
