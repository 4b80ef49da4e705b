// K8 resident_compact and K9 resident_fold: the resident engine's chunk
// compaction with its verdict partials, and the fold of one chunk into
// the level's device carry.
//
// Replaces: jaxmc/backend/bfs.py:2275 _get_resident_run, inside its
// level() program:
//   K8 (chunk site)   :2320-2355 the valid grid, gen, the maximum
//                     overflow code over fvalid, the first assert-bad
//                     flat index (argmax), the first dead slot, vcnt and
//                     the stable-sort compaction lax.sort((1 - cvalid,
//                     arange)) whose first VC indices pick the block;
//   K8 (explore site) :2483-2489 the same stable partition of the
//                     level's explore mask, its first FCap indices;
//   K9                :2396-2427 the block append at clamp(acc_n), the
//                     status priority and the first ASSERT / DEADLOCK
//                     row, guarded by the status as the reference's
//                     chunk_cond (:2429-2434) guards the whole chunk.
//
// K8 inputs: a bool mask [A*CH] read as mask[a*CH + f] && f < flim (the
// chunk: en with flim = fcount - base; the explore site: A = 1, CH =
// flim = C), a cap <= A*CH and, at the chunk site, aok [A, CH] bool and
// ov [A, CH] int32.  Outputs: idx [cap] int32, the first cap entries of
// the stable partition (set indices in index order, then the unset ones
// in index order) — exactly lax.sort's first cap indices; scalars
// int64[6] = (count of set entries, uncapped; maximum ov over f < flim;
// assert_any; first assert-bad flat index; dead_any; first dead slot).
// Bound on the card: bytes.  Each candidate's en, aok and ov read once
// (6 bytes; 1 byte a mask entry at the explore site), 4 bytes written
// per index.
// Design, as K7: three launches, nothing atomic, every output written by
// one thread, so the result is the same on every run.
//   a  (jmc_res_compact_count)    one thread per entry (and per slot for
//                                 dead): per-block set count
//                                 (__syncthreads_count) and reductions;
//   b  (jmc_res_compact_scan)     one block: exclusive scan of the block
//                                 counts, the scalar vector;
//   c  (jmc_res_compact_scatter)  one thread per entry: a set entry's
//                                 rank in its block from warp ballots
//                                 plus the block offset is its slot; an
//                                 unset entry's slot is count + its
//                                 index - the set entries before it.
//
// K9 inputs: the level carry int64[7] = (stat, acc_n, gen, ovcode,
// por_ample, por_expanded, por_masked) and bad_row [PW] in device memory,
// K8's scalars, K2's pack-overflow flag, the POR deltas int64[3] (or
// null), the VC block keys_c [VC, 5] and rows_c [VC, PW], the
// accumulators acc_keys [AccCap, 5] and acc_rows [AccCap, PW], the
// packed frontier and the chunk's base row.  When stat is ST_CONTINUE on
// entry, and only then, it writes the block at clamp(acc_n, 0, AccCap -
// VC), adds vcnt to acc_n, sets the status (ST_OVF_LANES, then ST_OVF_VC,
// then ST_OVF_ACC, then ASSERT / DEADLOCK with bad_row = frontier[base +
// f]) and adds gen, the overflow code and the POR counters.  Otherwise
// it writes nothing, so the host enqueues a level's chunks without
// reading anything between them.
// Bound on the card: bytes, VC * (5 + PW) words read and written.
// Design: two launches.  a (jmc_res_fold_copy), one thread per word,
// reads stat and acc_n and copies; b (jmc_res_fold_scalar), one thread,
// runs after a in stream order and folds the scalars.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int32_t kNone = 0x7FFFFFFF;

// the reference's ST_* codes (jaxmc/backend/bfs.py:58-68)
constexpr int64_t kContinue = 0;
constexpr int64_t kDeadlock = 3;
constexpr int64_t kAssert = 4;
constexpr int64_t kOvfAcc = 8;
constexpr int64_t kOvfVc = 9;
constexpr int64_t kOvfLanes = 10;

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

__global__ void compact_count_kernel(const bool* __restrict__ mask,
                                     const bool* __restrict__ aok,
                                     const int32_t* __restrict__ ov,
                                     int32_t* __restrict__ bcnt,
                                     int32_t* __restrict__ bov,
                                     int32_t* __restrict__ bab,
                                     int32_t* __restrict__ bdead, int a_n,
                                     int32_t ch, int32_t flim) {
  __shared__ int32_t s_ov[kWarps], s_ab[kWarps], s_dead[kWarps];
  const int64_t c = static_cast<int64_t>(a_n) * ch;
  const int32_t i = blockIdx.x * kThreads + threadIdx.x;
  const bool chunk = aok != nullptr;
  bool v = false;
  int32_t ovv = 0, ab = kNone, dd = kNone;
  if (i < c) {
    const bool fv = (i % ch) < flim;
    v = fv && mask[i];
    if (chunk && fv) {
      ovv = ov[i];
      if (!aok[i]) ab = i;
    }
  }
  if (chunk && i < ch) {
    bool any = false;
    for (int a = 0; a < a_n && !any; ++a)
      any = mask[static_cast<int64_t>(a) * ch + i];
    if (i < flim && !any) dd = i;
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

__global__ void compact_scan_kernel(const int32_t* __restrict__ bcnt,
                                    const int32_t* __restrict__ bov,
                                    const int32_t* __restrict__ bab,
                                    const int32_t* __restrict__ bdead,
                                    int32_t* __restrict__ boff,
                                    int64_t* __restrict__ scalars,
                                    int32_t nb) {
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
    scalars[0] = s_sum[kScanThreads - 1];
    scalars[1] = mm;
    scalars[2] = bb != kNone;
    scalars[3] = bb != kNone ? bb : 0;
    scalars[4] = ee != kNone;
    scalars[5] = ee != kNone ? ee : 0;
  }
}

__global__ void compact_scatter_kernel(const bool* __restrict__ mask,
                                       const int32_t* __restrict__ boff,
                                       const int64_t* __restrict__ scalars,
                                       int32_t* __restrict__ idx, int a_n,
                                       int32_t ch, int32_t flim,
                                       int32_t cap) {
  __shared__ int32_t s_warp[kWarps];
  const int64_t c = static_cast<int64_t>(a_n) * ch;
  const int32_t i = blockIdx.x * kThreads + threadIdx.x;
  const bool in = i < c;
  const bool v = in && (i % ch) < flim && mask[i];
  const unsigned ball = __ballot_sync(0xFFFFFFFFu, v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_warp[warp] = __popc(ball);
  __syncthreads();
  if (!in) return;
  // set entries before i: those of earlier blocks, warps and lanes
  int32_t before = boff[blockIdx.x] + __popc(ball & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) before += s_warp[w];
  const int32_t pos =
      v ? before : static_cast<int32_t>(scalars[0]) + (i - before);
  if (pos < cap) idx[pos] = i;
}

__global__ void fold_copy_kernel(const int64_t* __restrict__ carry,
                                 const int32_t* __restrict__ keys_c,
                                 const int32_t* __restrict__ rows_c,
                                 int32_t* __restrict__ acc_keys,
                                 int32_t* __restrict__ acc_rows, int32_t vc,
                                 int64_t acc_cap, int kw, int pw) {
  if (carry[0] != kContinue) return;
  int64_t off = carry[1];
  off = off < 0 ? 0 : (off > acc_cap - vc ? acc_cap - vc : off);
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;
  const int64_t nk = static_cast<int64_t>(vc) * kw;
  if (t < nk) {
    const int64_t r = t / kw, j = t % kw;
    acc_keys[(off + r) * kw + j] = keys_c[t];
  } else if (t < nk + static_cast<int64_t>(vc) * pw) {
    const int64_t u = t - nk, r = u / pw, j = u % pw;
    acc_rows[(off + r) * pw + j] = rows_c[u];
  }
}

__global__ void fold_scalar_kernel(int64_t* __restrict__ carry,
                                   int32_t* __restrict__ bad_row,
                                   const int64_t* __restrict__ part,
                                   const bool* __restrict__ pack_ovf,
                                   const int64_t* __restrict__ por,
                                   const int32_t* __restrict__ frontier,
                                   int64_t base, int32_t ch, int32_t vc,
                                   int64_t acc_cap, int pw,
                                   int check_deadlock, int32_t ov_pack) {
  if (carry[0] != kContinue) return;
  const int64_t vcnt = part[0];
  const int64_t acc_n = carry[1] + vcnt;
  const int64_t masked = por != nullptr ? por[2] : 0;
  int64_t ovcode = carry[3] > part[1] ? carry[3] : part[1];
  const bool povf = *pack_ovf;
  // kernel overflow codes outrank the pack guard
  if (ovcode == 0 && povf) ovcode = ov_pack;
  const bool lanes = part[1] != 0 || povf;
  int64_t stat = lanes ? kOvfLanes
                       : (vcnt > vc ? kOvfVc
                                    : (acc_n + vc > acc_cap ? kOvfAcc
                                                            : kContinue));
  const bool ab_any = part[2] != 0;
  const bool dead_any = check_deadlock && part[4] != 0;
  if (stat == kContinue && (ab_any || dead_any)) {
    const int64_t f = ab_any ? part[3] % ch : part[5];
    const int64_t src = (base + f) * pw;
    for (int j = 0; j < pw; ++j) bad_row[j] = frontier[src + j];
    stat = ab_any ? kAssert : kDeadlock;
  }
  carry[0] = stat;
  carry[1] = acc_n;
  carry[2] += vcnt - masked;
  carry[3] = ovcode;
  if (por != nullptr) {
    carry[4] += por[0];
    carry[5] += por[1];
    carry[6] += masked;
  }
}

inline int32_t blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int32_t>(b < 1 ? 1 : b);
}

}  // namespace

extern "C" int jmc_res_threads() { return kThreads; }

extern "C" cudaError_t jmc_res_compact_count(
    const bool* mask, const bool* aok, const int32_t* ov, int32_t* bcnt,
    int32_t* bov, int32_t* bab, int32_t* bdead, int a_n, int32_t ch,
    int32_t flim, cudaStream_t stream) {
  const int64_t c = static_cast<int64_t>(a_n) * ch;
  const int32_t nb = blocks_for(c > ch ? c : ch);
  compact_count_kernel<<<nb, kThreads, 0, stream>>>(
      mask, aok, ov, bcnt, bov, bab, bdead, a_n, ch, flim);
  return cudaGetLastError();
}

extern "C" cudaError_t jmc_res_compact_scan(const int32_t* bcnt,
                                            const int32_t* bov,
                                            const int32_t* bab,
                                            const int32_t* bdead,
                                            int32_t* boff, int64_t* scalars,
                                            int32_t nb, cudaStream_t stream) {
  compact_scan_kernel<<<1, kScanThreads, 0, stream>>>(bcnt, bov, bab, bdead,
                                                      boff, scalars, nb);
  return cudaGetLastError();
}

extern "C" cudaError_t jmc_res_compact_scatter(
    const bool* mask, const int32_t* boff, const int64_t* scalars,
    int32_t* idx, int a_n, int32_t ch, int32_t flim, int32_t cap,
    cudaStream_t stream) {
  const int64_t c = static_cast<int64_t>(a_n) * ch;
  if (c <= 0 || cap <= 0) return cudaSuccess;
  compact_scatter_kernel<<<blocks_for(c), kThreads, 0, stream>>>(
      mask, boff, scalars, idx, a_n, ch, flim, cap);
  return cudaGetLastError();
}

extern "C" cudaError_t jmc_res_fold_copy(const int64_t* carry,
                                         const int32_t* keys_c,
                                         const int32_t* rows_c,
                                         int32_t* acc_keys, int32_t* acc_rows,
                                         int32_t vc, int64_t acc_cap, int kw,
                                         int pw, cudaStream_t stream) {
  const int64_t n = static_cast<int64_t>(vc) * (kw + pw);
  if (n <= 0) return cudaSuccess;
  fold_copy_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      carry, keys_c, rows_c, acc_keys, acc_rows, vc, acc_cap, kw, pw);
  return cudaGetLastError();
}

extern "C" cudaError_t jmc_res_fold_scalar(
    int64_t* carry, int32_t* bad_row, const int64_t* part,
    const bool* pack_ovf, const int64_t* por, const int32_t* frontier,
    int64_t base, int32_t ch, int32_t vc, int64_t acc_cap, int pw,
    int check_deadlock, int32_t ov_pack, cudaStream_t stream) {
  fold_scalar_kernel<<<1, 1, 0, stream>>>(carry, bad_row, part, pack_ovf, por,
                                          frontier, base, ch, vc, acc_cap, pw,
                                          check_deadlock, ov_pack);
  return cudaGetLastError();
}
