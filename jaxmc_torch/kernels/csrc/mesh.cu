// K13 mesh_route and K14 mesh_scalars: the mesh engine's owner-routed
// exchange and the level's replicated scalar vector, for D shards that
// share one card (or, in the multi-process runner, one shard per rank).
//
// Replaces: jaxmc/backend/mesh.py
//   K13 a2a     :481-537 route_a2a: the owner of each valid candidate
//               (key lane 1 mod D, or shard 0 under the mesh_skew fault:
//               _owner_jnp, :424-431), the stable sort by destination,
//               the per-destination histogram and exclusive prefix, each
//               row's position in its destination, the scatter of the
//               [keys | packed row | srcid] payload into the [D, B] main
//               buckets and the [D, SB] spill buckets (positions B..B+SB-1
//               of the same order), and the two all_to_alls that hand
//               destination d every source's buckets;
//   K13 gather  :453-469 route_gather after its all_gather: the
//               ownership mask `mine = valid & owner == me` over the
//               gathered [D*C, K] keys, foreign and invalid rows set to
//               the invalid key;
//   K14         :1013-1100 (and :870-913 of the legacy step) the psum,
//               pmax and pmin over the shard axis that make the [_NS]
//               replicated scalar vector, and the [_NA] per-shard
//               violation-localization vectors.
//
// K13 a2a inputs: keys [S, C, K] int32, cand [S, C, PW] int32, valid
// [S, C] bool for S source shards (global indices src_lo .. src_lo+S-1),
// D destinations, bucket B and spill bucket SB.  R = D * (B + SB) rows
// per shard.  Outputs: okeys [O, R, K], ocand [O, R, PW], osrc [O, R]
// int32 and stats [S, 3] int32 = (spill rows, bucket+spill overflow,
// largest destination count) per source.  Layout "recv" (O = D, S = D):
// shard d's rows are the reference's received block, every source's
// main bucket (source s at s*B) then every source's spill bucket (at
// D*B + s*SB).  Layout "send" (O = S): source s's rows are its send
// block, destination-major main buckets (d*B) then spill buckets (D*B +
// d*SB), which all_to_all_single turns into the receive block.  A row at
// position p of its destination goes to the main bucket if p < B, else
// to the spill bucket if p < B + SB, else nowhere (the overflow flag).
// Every other slot holds the invalid shape: key lane 0 = 1, every other
// word SENTINEL (srcid included).
// What must match the reference: every output bit for bit (the slots
// are the reference's, so traces and the merge's candidate order hold).
// Bound on the card: bytes.  Each candidate's keys, row and flag read
// once, every output slot written once.
// Design: four launches, nothing atomic, every output written by one
// thread, so the result is the same on every run.
//   a  (jmc_mesh_route_fill)     grid-stride: every slot the invalid
//                                shape;
//   b  (jmc_mesh_route_count)    one thread per candidate, grid (blocks,
//                                S): per-block count of each destination
//                                (__syncthreads_count, D of them);
//   c  (jmc_mesh_route_scan)     one block per (source, destination):
//                                exclusive scan of the block counts and
//                                the destination's total;
//   d  (jmc_mesh_route_scatter)  one thread per candidate: its rank in
//                                its destination within the block from
//                                warp ballots, plus the block offset, is
//                                its position; block 0 of each source
//                                also folds the totals into stats.
//
// K13 gather inputs: the gathered keys [N, K] int32 (N = D*C, the
// validity lane decides, as the reference's gvalid), D, the first shard
// me_lo and the number of shards n_me to write.  Outputs: okeys [n_me,
// N, K] int32, shard m's rows masked to those it owns, and evalid [N]
// bool, the validity before the mask (the edge stream's).  The packed
// rows are not copied: every shard reads the one gathered block.
// Bound: bytes, N*K words read, n_me*N*K words and N flags written.
// Design: one launch, one thread per output row (grid-stride).
//
// K14 inputs: partials [D, NP] int32, one row per shard (the P_* columns
// below), the frontier and seen capacities FC and SC and the trace-ring
// overflow flag.  Output [NS + D*NA + D*NP] int32: the reference's
// _S_* vector (sums, maxima, the minimum and the flags over the shard
// axis), the _A_* localization vector of each shard, then the partials
// themselves, so the host reads one vector per level.  Sums wrap as the
// reference's int32 psum does.
// Bound: bytes, D*NP words read, NS + D*(NA+NP) words written.
// Design: one block; thread t < NS reduces column t over the shards, the
// others copy.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int kMaxDest = 64;
constexpr int32_t kSent = 0x7FFFFFFF;

// K14: the partial columns (ops.py MESH_PARTIALS) ...
enum {
  P_GEN, P_FRONT, P_SEEN, P_SPILL, P_MAXDEST, P_VNEED, P_OVC, P_DEAD,
  P_DEADSLOT, P_ASSERT, P_ASRTA, P_ASRTF, P_INVW, P_INVSLOT, P_PORA,
  P_PORX, P_PORM, P_AOVF, P_VOVF, NP
};
// ... the reference's scalar vector (mesh.py:121-142) ...
enum {
  S_GEN, S_NEW, S_FRONT, S_MAXF, S_MAXS, S_SUMS, S_OVC, S_DEAD, S_ASSERT,
  S_INVMIN, S_FOVF, S_SOVF, S_TOVF, S_AOVF, S_SPILL, S_MAXDEST, S_VOVF,
  S_MAXV, S_PORA, S_PORX, S_PORM, NS
};
// ... and its localization vector (mesh.py:145-152)
constexpr int NA = 7;
__constant__ int kAuxCol[NA] = {P_INVW, P_INVSLOT, P_DEAD, P_DEADSLOT,
                                P_ASSERT, P_ASRTA, P_ASRTF};

__device__ __forceinline__ int dest_of(const int32_t* __restrict__ keys,
                                       const bool* __restrict__ valid,
                                       int64_t i, int k, int d, int skew) {
  if (!valid[i]) return d;
  if (skew) return 0;
  return static_cast<int>(static_cast<uint32_t>(keys[i * k + 1]) %
                          static_cast<uint32_t>(d));
}

__global__ void route_fill_kernel(int32_t* __restrict__ okeys,
                                  int32_t* __restrict__ ocand,
                                  int32_t* __restrict__ osrc, int64_t rows,
                                  int k, int pw) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads +
                   threadIdx.x;
       r < rows; r += stride) {
    int32_t* kr = okeys + r * k;
    kr[0] = 1;
    for (int j = 1; j < k; ++j) kr[j] = kSent;
    int32_t* cr = ocand + r * pw;
    for (int j = 0; j < pw; ++j) cr[j] = kSent;
    osrc[r] = kSent;
  }
}

__global__ void route_count_kernel(const int32_t* __restrict__ keys,
                                   const bool* __restrict__ valid,
                                   int32_t* __restrict__ bcnt, int64_t c,
                                   int k, int d, int skew, int32_t nb) {
  const int64_t s = blockIdx.y;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int dst = d;
  if (i < c) dst = dest_of(keys + s * c * k, valid + s * c, i, k, d, skew);
  for (int j = 0; j < d; ++j) {
    const int32_t cnt = __syncthreads_count(dst == j);
    if (threadIdx.x == 0) bcnt[(s * d + j) * nb + blockIdx.x] = cnt;
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
  s_sum[t] = sum;
  __syncthreads();
  for (int o = 1; o < kScanThreads; o <<= 1) {
    const int64_t add = t >= o ? s_sum[t - o] : 0;
    __syncthreads();
    s_sum[t] += add;
    __syncthreads();
  }
  int64_t run = s_sum[t] - sum;
  for (int32_t j = lo; j < hi; ++j) {
    off[j] = run;
    run += cnt[j];
  }
  const int64_t total = s_sum[kScanThreads - 1];
  __syncthreads();
  return total;
}

__global__ void route_scan_kernel(const int32_t* __restrict__ bcnt,
                                  int64_t* __restrict__ boff,
                                  int64_t* __restrict__ totals, int32_t nb) {
  __shared__ int64_t s_sum[kScanThreads];
  const int64_t sd = blockIdx.x;
  const int64_t total = block_scan(bcnt + sd * nb, boff + sd * nb, nb, s_sum);
  if (threadIdx.x == 0) totals[sd] = total;
}

__global__ void route_scatter_kernel(
    const int32_t* __restrict__ keys, const int32_t* __restrict__ cand,
    const bool* __restrict__ valid, const int64_t* __restrict__ boff,
    const int64_t* __restrict__ totals, int32_t* __restrict__ okeys,
    int32_t* __restrict__ ocand, int32_t* __restrict__ osrc,
    int32_t* __restrict__ stats, int64_t c, int k, int pw, int d, int64_t b,
    int64_t sb, int skew, int64_t src_lo, int send, int32_t nb) {
  __shared__ int32_t s_w[kWarps][kMaxDest];
  const int64_t s = blockIdx.y;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int32_t* skeys = keys + s * c * k;
  int dst = d;
  if (i < c) dst = dest_of(skeys, valid + s * c, i, k, d, skew);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int32_t wrank = 0;
  for (int j = 0; j < d; ++j) {
    const unsigned bal = __ballot_sync(0xFFFFFFFFu, dst == j);
    if (lane == 0) s_w[warp][j] = __popc(bal);
    if (dst == j) wrank = __popc(bal & below);
  }
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int64_t spill = 0, maxd = 0;
    int32_t ovf = 0;
    for (int j = 0; j < d; ++j) {
      const int64_t n = totals[s * d + j];
      spill += n > b ? (n - b < sb ? n - b : sb) : 0;
      if (n > b + sb) ovf = 1;
      if (n > maxd) maxd = n;
    }
    stats[s * 3 + 0] = static_cast<int32_t>(spill);
    stats[s * 3 + 1] = ovf;
    stats[s * 3 + 2] = static_cast<int32_t>(maxd);
  }
  if (dst >= d) return;
  int64_t pos = boff[(s * d + dst) * nb + blockIdx.x] + wrank;
  for (int w = 0; w < warp; ++w) pos += s_w[w][dst];
  const int64_t r = d * (b + sb);
  const int64_t sg = src_lo + s;
  int64_t slot;
  if (pos < b) {
    slot = send ? s * r + dst * b + pos : dst * r + sg * b + pos;
  } else if (pos < b + sb) {
    const int64_t q = pos - b;
    slot = send ? s * r + d * b + dst * sb + q
                : dst * r + d * b + sg * sb + q;
  } else {
    return;
  }
  const int32_t* kin = skeys + i * k;
  int32_t* kout = okeys + slot * k;
  for (int j = 0; j < k; ++j) kout[j] = kin[j];
  const int32_t* cin = cand + (s * c + i) * pw;
  int32_t* cout = ocand + slot * pw;
  for (int j = 0; j < pw; ++j) cout[j] = cin[j];
  osrc[slot] = static_cast<int32_t>(sg * c + i);
}

__global__ void route_gather_kernel(const int32_t* __restrict__ keys,
                                    int32_t* __restrict__ okeys,
                                    bool* __restrict__ evalid, int64_t n,
                                    int k, int d, int me_lo, int n_me,
                                    int skew) {
  const int64_t total = n * n_me;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads +
                   threadIdx.x;
       t < total; t += stride) {
    const int64_t m = t / n, r = t % n;
    const int32_t* row = keys + r * k;
    const bool v = row[0] == 0;
    const int owner =
        skew ? 0
             : static_cast<int>(static_cast<uint32_t>(row[1]) %
                                static_cast<uint32_t>(d));
    const bool mine = v && owner == me_lo + m;
    int32_t* out = okeys + t * k;
    if (mine) {
      for (int j = 0; j < k; ++j) out[j] = row[j];
    } else {
      out[0] = 1;
      for (int j = 1; j < k; ++j) out[j] = kSent;
    }
    if (m == 0) evalid[r] = v;
  }
}

__global__ void scalars_kernel(const int32_t* __restrict__ part,
                               int32_t* __restrict__ out, int d,
                               int32_t fc, int32_t sc, int32_t tovf) {
  const int t = threadIdx.x;
  if (t < NS) {
    // sums in uint32, so they wrap as the reference's int32 psum
    uint32_t sum = 0;
    int32_t mx = 0, mn = 0x7FFFFFFF, any = 0;
    int col = 0, kind = 0;  // kind: 0 sum, 1 max, 2 min, 3 any-flag
    switch (t) {
      case S_GEN: col = P_GEN; break;
      case S_NEW: case S_FRONT: col = P_FRONT; break;
      case S_MAXF: col = P_FRONT; kind = 1; break;
      case S_MAXS: col = P_SEEN; kind = 1; break;
      case S_SUMS: col = P_SEEN; break;
      case S_OVC: col = P_OVC; kind = 1; break;
      case S_DEAD: col = P_DEAD; break;
      case S_ASSERT: col = P_ASSERT; break;
      case S_INVMIN: col = P_INVW; kind = 2; break;
      case S_FOVF: col = P_FRONT; kind = 3; break;
      case S_SOVF: col = P_SEEN; kind = 3; break;
      case S_TOVF: kind = 4; break;
      case S_AOVF: col = P_AOVF; kind = 3; break;
      case S_SPILL: col = P_SPILL; break;
      case S_MAXDEST: col = P_MAXDEST; kind = 1; break;
      case S_VOVF: col = P_VOVF; kind = 3; break;
      case S_MAXV: col = P_VNEED; kind = 1; break;
      case S_PORA: col = P_PORA; break;
      case S_PORX: col = P_PORX; break;
      case S_PORM: col = P_PORM; break;
    }
    for (int j = 0; j < d; ++j) {
      const int32_t v = part[j * NP + col];
      sum += static_cast<uint32_t>(v);
      mx = max(mx, v);
      mn = min(mn, v);
      if (t == S_FOVF) any |= v > fc;
      else if (t == S_SOVF) any |= v > sc;
      else any |= v != 0;
    }
    int32_t r;
    switch (kind) {
      case 0: r = static_cast<int32_t>(sum); break;
      case 1: r = mx; break;
      case 2: r = mn; break;
      case 3: r = any; break;
      default: r = tovf; break;
    }
    out[t] = r;
  }
  for (int j = t; j < d * NA; j += blockDim.x)
    out[NS + j] = part[(j / NA) * NP + kAuxCol[j % NA]];
  for (int j = t; j < d * NP; j += blockDim.x) out[NS + d * NA + j] = part[j];
}

inline int32_t blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int32_t>(b < 1 ? 1 : b);
}

inline int32_t grid_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int32_t>(b < 1 ? 1 : (b > 65536 ? 65536 : b));
}

}  // namespace

extern "C" int jmc_mesh_threads() { return kThreads; }

extern "C" cudaError_t jmc_mesh_route_fill(int32_t* okeys, int32_t* ocand,
                                           int32_t* osrc, int64_t rows,
                                           int k, int pw,
                                           cudaStream_t stream) {
  if (rows <= 0) return cudaSuccess;
  route_fill_kernel<<<grid_for(rows), kThreads, 0, stream>>>(
      okeys, ocand, osrc, rows, k, pw);
  return cudaGetLastError();
}

extern "C" cudaError_t jmc_mesh_route_count(const int32_t* keys,
                                            const bool* valid, int32_t* bcnt,
                                            int64_t c, int k, int d,
                                            int skew, int s_n, int32_t nb,
                                            cudaStream_t stream) {
  route_count_kernel<<<dim3(nb, s_n), kThreads, 0, stream>>>(
      keys, valid, bcnt, c, k, d, skew, nb);
  return cudaGetLastError();
}

extern "C" cudaError_t jmc_mesh_route_scan(const int32_t* bcnt, int64_t* boff,
                                           int64_t* totals, int sd_n,
                                           int32_t nb, cudaStream_t stream) {
  route_scan_kernel<<<sd_n, kScanThreads, 0, stream>>>(bcnt, boff, totals,
                                                       nb);
  return cudaGetLastError();
}

extern "C" cudaError_t jmc_mesh_route_scatter(
    const int32_t* keys, const int32_t* cand, const bool* valid,
    const int64_t* boff, const int64_t* totals, int32_t* okeys,
    int32_t* ocand, int32_t* osrc, int32_t* stats, int64_t c, int k, int pw,
    int d, int64_t b, int64_t sb, int skew, int64_t src_lo, int send,
    int s_n, int32_t nb, cudaStream_t stream) {
  route_scatter_kernel<<<dim3(nb, s_n), kThreads, 0, stream>>>(
      keys, cand, valid, boff, totals, okeys, ocand, osrc, stats, c, k, pw,
      d, b, sb, skew, src_lo, send, nb);
  return cudaGetLastError();
}

extern "C" cudaError_t jmc_mesh_route_gather(const int32_t* keys,
                                             int32_t* okeys, bool* evalid,
                                             int64_t n, int k, int d,
                                             int me_lo, int n_me, int skew,
                                             cudaStream_t stream) {
  if (n <= 0 || n_me <= 0) return cudaSuccess;
  route_gather_kernel<<<grid_for(n * n_me), kThreads, 0, stream>>>(
      keys, okeys, evalid, n, k, d, me_lo, n_me, skew);
  return cudaGetLastError();
}

extern "C" cudaError_t jmc_mesh_scalars(const int32_t* part, int32_t* out,
                                        int d, int32_t fc, int32_t sc,
                                        int32_t tovf, cudaStream_t stream) {
  scalars_kernel<<<1, 64, 0, stream>>>(part, out, d, fc, sc, tovf);
  return cudaGetLastError();
}
