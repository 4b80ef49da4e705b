// K2 keys_of: unpacked candidate rows -> dedup keys + packed rows.
//
// Replaces: jaxmc/compile/pack.py:441 LanePlan.pack_rows inside
// jaxmc/backend/bfs.py:1584 TpuExplorer._keys_of (bias, range guard,
// sentinel code, shift into word, OR of disjoint fields; SENTINEL fill
// of invalid rows; validity lane first), fused with
// jaxmc/backend/bfs.py:126 fingerprint128 when the engine keys on
// 128-bit fingerprints (fp_mode).  The key basis is one of three
// (bfs.py:1604-1629): the stored packed row itself; the SYMMETRY
// canonical rows packed with the same plan, whose range guard ORs into
// the same overflow flag (a permutation can move a value into a lane
// whose profiled range the raw rows never left); or the VIEW's value
// lanes, used raw.  The stored packed row is always the raw state.
//
// Bound on the card: bytes.  Every validity byte is read (N bytes),
// the lanes of the valid rows only (valid*W*4; an invalid row is never
// read), plus the valid rows of a separate basis (valid*W*4 canonical
// or valid*Vw*4 view lanes), and every row's key and packed words are
// written once (N*(PW+K)*4 bytes); the work per lane is a few integer
// operations, and the fingerprint adds 8 multiplies per key word.
//
// Design: one launch; each warp works tiles of RW rows (128) on its own,
// grid-stride, with no barrier but its own, so that many tiles are in
// flight on a SM (each warp waits on its own loads, as the one-thread-a-
// row kernel's threads did).  A block stages the lane plan in shared
// memory once, a lane as one 16-byte entry (every lane of a warp reads
// the same entry: a broadcast).  Per tile the warp lists the valid rows
// in row order (each lane's RW / 32 validity bytes in one load, a warp
// scan of their counts; its next tile's bytes are loaded while this
// tile is worked), then takes the listed rows P at a time (32, or 64
// for exact keys over the stored row or raw lanes): their lanes, and
// the basis lanes, come into the warp's shared memory by asynchronous
// copies (cp.async), all of a pass in flight at once; a lane takes one
// word of 32 / W rows an instruction (neighbouring lanes on neighbouring
// words, row stride W | 1), and a pass whose rows are one run of rows
// comes in 16 bytes at a time.  Lane u packs and keys the u-th row of
// the pass there, the canonical row in the same walk of the plan as the
// stored row.  The plan assigns lanes to words in increasing order
// (pack.py's greedy placement), so a row's lanes are walked once, each
// packed word ORed up in a register and handed on when the lane's word
// index moves on; key words stream into KeyAcc, which stores them
// (exact) or mixes them into four registers (fp128).  The tile's key
// and packed rows are staged in shared memory at the 16-byte phase of
// their destination and written as one run of 16-byte stores with a
// scalar head and tail; an invalid row's words are filled as they go out
// ((1, SENTINEL...) keys, SENTINEL packed words), so an invalid row is
// neither read nor staged.  The overflow flag: a block that saw a
// guarded lane out of range ORs one word of the workspace; the block
// finishing last reads it into the bool output and clears it and the
// done count, so the words are zero between calls (no memset, nothing
// after the launch, nothing kept across calls: a call can be captured in
// a CUDA graph).  A caller that wants the per-row flags of the stored
// rows (LanePlan.pack_rows) passes row_ovf; the level step passes null.
// The wrapper picks the warps a block, RW and P from the widths
// (kernels/ops.py keys_geometry).

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kSentinel = 0x7FFFFFFF;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
// the dynamic shared memory a block takes without opting in (48 KB less
// the kernels' static shared memory, at most 1 KB)
constexpr int kSmemDefault = 47 * 1024;

__constant__ uint32_t kMix1[4] = {0x9E3779B1u, 0xC2B2AE35u, 0x165667B1u,
                                  0x85EBCA6Bu};
__constant__ uint32_t kMix2[4] = {0x85EBCA6Bu, 0x27D4EB2Fu, 0x9E3779B1u,
                                  0xC2B2AE35u};

// key basis: the stored packed row, another row block packed with the
// same plan (the SYMMETRY canonical rows), or raw lanes (the VIEW)
enum Basis { kStored = 0, kPackOther = 1, kRaw = 2 };

struct Plan {
  const int32_t *word, *shift, *mask, *bias, *allowed, *full, *sent_code;
};

__host__ __device__ __forceinline__ int pad4(int w) { return (w + 3) & ~3; }

// a runtime call's error, taken off the thread's last-error state so that
// the next call's check after its launch does not report it again
inline cudaError_t fail(cudaError_t err) {
  cudaGetLastError();
  return err;
}

// the word phase of p in its 16-byte sector (0..3)
__device__ __forceinline__ int phase4(const int32_t* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3u);
}

// A lane of the plan as a block stages it: bias, allowed (the range
// guard's top), mask, and meta = word | shift << 16 | full lane << 24 |
// has a sentinel code << 25; the sentinel codes beside them
constexpr uint32_t kFullBit = 1u << 24;
constexpr uint32_t kScBit = 1u << 25;

// Pack NR rows with the staged plan in one walk of its lanes, handing
// each finished word of every row to emit(p, words[NR]) in increasing p;
// bad[r] is row r's range-guard verdict (a guarded lane outside its
// profiled range).  The plan assigns lanes to words in increasing order.
template <int NR, class Emit>
__device__ inline void pack_rows(const int32_t* const (&row)[NR], int w,
                                 int pw, const int4* __restrict__ pq,
                                 const int32_t* __restrict__ psc,
                                 bool (&bad)[NR], Emit emit) {
  uint32_t acc[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    acc[r] = 0;
    bad[r] = false;
  }
  int cur = 0;
  for (int i = 0; i < w; ++i) {
    const int4 q = pq[i];
    const uint32_t meta = static_cast<uint32_t>(q.w);
    const int wd = static_cast<int>(meta & 0xFFFFu);
    while (cur < wd) {  // lanes fill words in increasing order
      emit(cur, acc);
#pragma unroll
      for (int r = 0; r < NR; ++r) acc[r] = 0;
      ++cur;
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int32_t v = row[r][i];
      uint32_t code_u = static_cast<uint32_t>(v);
      if (!(meta & kFullBit)) {
        const int32_t code =
            ((meta & kScBit) && v == kSentinel)
                ? psc[i]
                : static_cast<int32_t>(static_cast<uint32_t>(v) -
                                       static_cast<uint32_t>(q.x));
        bad[r] |= (code < 0) || (code > q.y);
        code_u = static_cast<uint32_t>(code);
      }
      acc[r] |= (code_u & static_cast<uint32_t>(q.z)) << ((meta >> 16) & 31u);
    }
  }
  while (cur < pw) {
    emit(cur, acc);
#pragma unroll
    for (int r = 0; r < NR; ++r) acc[r] = 0;
    ++cur;
  }
}

// The key words of one row, fed a word at a time: stored as they come
// (exact keys) or mixed into the four fingerprint streams (fp128).
template <bool FP>
struct KeyAcc {
  int32_t* krow;
  uint32_t h[4];
  int p;
  __device__ explicit KeyAcc(int32_t* k) : krow(k), p(0) {
    for (int j = 0; j < 4; ++j)
      h[j] = 2166136261u + static_cast<uint32_t>(j) * 0x9E3779B1u;
  }
  __device__ void put(uint32_t x) {
    if (FP) {
      for (int j = 0; j < 4; ++j) h[j] = (h[j] ^ (x * kMix1[j])) * kMix2[j];
    } else {
      krow[1 + p] = static_cast<int32_t>(x);
    }
    ++p;
  }
  __device__ void finish() {
    krow[0] = 0;
    if (FP) {
      for (int j = 0; j < 4; ++j) {
        uint32_t x = h[j];
        x ^= x >> 15;
        x *= 0x2C1B3C6Du;
        x ^= x >> 12;
        krow[1 + j] = static_cast<int32_t>(x);
      }
    }
  }
};

// g[i] = word i of the staged rows s (at g's 16-byte phase), i in
// [0, nw), rows of k words, by one warp: a scalar head, 16-byte loads
// and stores, a scalar tail.  A word of a row whose flag byte (rb) has
// bit 0 clear, an invalid row, is the fill instead: (1, SENTINEL...) for
// a key (`key`), SENTINEL for a packed row.
__device__ void rows_out(const int32_t* __restrict__ s, int nw, int k,
                         const uint8_t* __restrict__ rb, bool key,
                         int32_t* __restrict__ g, int lane) {
  auto word = [&](int32_t x, int row, int c) -> int32_t {
    return (rb[row] & 1) ? x : ((key && c == 0) ? 1 : kSentinel);
  };
  const int h = min((4 - phase4(g)) & 3, nw), nv = (nw - h) >> 2;
  if (lane < h) g[lane] = word(s[lane], lane / k, lane % k);
  const int4* sv = reinterpret_cast<const int4*>(s + h);
  int4* gv = reinterpret_cast<int4*>(g + h);
  for (int v = lane; v < nv; v += 32) {
    const int4 q = sv[v];
    int32_t e[4] = {q.x, q.y, q.z, q.w};
    const int i = h + 4 * v;
    int row = i / k, c = i - row * k;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      e[j] = word(e[j], row, c);
      if (++c == k) {
        c = 0;
        ++row;
      }
    }
    gv[v] = make_int4(e[0], e[1], e[2], e[3]);
  }
  const int i = h + 4 * nv + lane;
  if (i < nw) g[i] = word(s[i], i / k, i % k);
}

// s[u * ws + c] = lane c of the u-th of the m listed rows, by one warp's
// asynchronous copies (cp.async), every copy in flight at once: a lane
// keeps one word c of a row and the warp takes 32 / w rows an
// instruction (neighbouring lanes on neighbouring words); rows wider
// than a warp a row at a time.  The caller commits and waits.
__device__ void rows_in(const int32_t* __restrict__ g, int64_t r0,
                        const uint8_t* __restrict__ list, int m, int w,
                        int ws, int32_t* __restrict__ s, int lane) {
  if (m == 0 || w == 0) return;
  if (w <= 32) {
    const int rpi = 32 / w;  // rows an instruction
    const int u0 = lane / w, c = lane - u0 * w;
    if (u0 >= rpi) return;
    const int32_t* gc = g + r0 * w + c;
    int32_t* sc = s + u0 * ws + c;
    for (int u = u0; u < m; u += rpi, sc += rpi * ws)
      __pipeline_memcpy_async(sc, gc + list[u] * w, 4);
    return;
  }
  for (int u = 0; u < m; ++u) {
    const int32_t* gr = g + (r0 + list[u]) * w;
    for (int c = lane; c < w; c += 32)
      __pipeline_memcpy_async(s + u * ws + c, gr + c, 4);
  }
}

// s[o + i] = g[i] for i in [0, nw), o = g's word phase, by one warp's
// asynchronous copies: 16 bytes at a time between a scalar head and
// tail (a pass whose listed rows are one run of rows).  Returns o.
__device__ int run_in(const int32_t* __restrict__ g, int nw,
                      int32_t* __restrict__ s, int lane) {
  const int o = phase4(g);
  const int h = min((4 - o) & 3, nw), nv = (nw - h) >> 2;
  if (lane < h) __pipeline_memcpy_async(s + o + lane, g + lane, 4);
  for (int v = lane; v < nv; v += 32)
    __pipeline_memcpy_async(s + o + h + 4 * v, g + h + 4 * v, 16);
  const int i = h + 4 * nv + lane;
  if (i < nw) __pipeline_memcpy_async(s + o + i, g + i, 4);
  return o;
}

// bit j set when row r0 + lane * per + j (below n) is valid: one load of
// the lane's per bytes when they are whole and aligned
__device__ __forceinline__ uint32_t valid_bits(const bool* valid, int64_t r0,
                                               int64_t n, int per, int lane) {
  const int64_t r = r0 + static_cast<int64_t>(lane) * per;
  if (r >= n) return 0;
  const bool* p = valid + r;
  if (per == 4 && r + 4 <= n && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
    const uint32_t x = *reinterpret_cast<const uint32_t*>(p);
    return (x & 0xFFu ? 1u : 0u) | (x & 0xFF00u ? 2u : 0u) |
           (x & 0xFF0000u ? 4u : 0u) | (x & 0xFF000000u ? 8u : 0u);
  }
  uint32_t b = 0;
  for (int j = 0; j < per && r + j < n; ++j)
    if (p[j]) b |= 1u << j;
  return b;
}

// The shared memory of one warp, in words (each part from a 16-byte
// boundary): the list of valid rows and a flag byte a row (bit 0 valid,
// bit 1 a guarded lane out of range), RW bytes each; the lanes of P
// listed rows at stride ws and their basis lanes at stride bws (none
// for the stored basis: bws 0), each with 3 words of room for a run's
// phase; the tile's staged key and packed rows, each with 3 words of
// room for its 16-byte phase
__device__ inline int warp_words(int RW, int P, int ws, int bws,
                                          int k, int pw) {
  return 2 * pad4((RW + 3) / 4) + pad4(P * ws + 3) +
         (bws ? pad4(P * bws + 3) : 0) + pad4(RW * k + 3) + pad4(RW * pw + 3);
}

template <bool FP, int BASIS>
__global__ void __launch_bounds__(kThreads)
    keys_of_kernel(const int32_t* __restrict__ rows,
                   const bool* __restrict__ valid, Plan gpl,
                   const int32_t* __restrict__ basis, int bw,
                   int32_t* __restrict__ keys, int32_t* __restrict__ packed,
                   bool* __restrict__ ovf_out, bool* __restrict__ row_ovf,
                   uint32_t* acc, int64_t n, int w, int pw, int RW, int P) {
  extern __shared__ int4 smem4[];
  int32_t* sm = reinterpret_cast<int32_t*>(smem4);
  const int k = (FP ? 4 : (BASIS == kRaw ? bw : pw)) + 1;
  const int ws = w | 1;
  const int bwl = BASIS == kRaw ? bw : w;  // the basis lanes of a row
  const int bws = BASIS == kStored ? 0 : (bwl | 1);
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const int warps = blockDim.x >> 5;
  int4* pq = smem4;  // the staged plan, a lane an int4, then the codes
  int32_t* psc = sm + 4 * w;
  for (int i = t; i < w; i += blockDim.x) {
    const int32_t sc = gpl.sent_code[i];
    pq[i] = make_int4(
        gpl.bias[i], gpl.allowed[i], gpl.mask[i],
        static_cast<int32_t>(static_cast<uint32_t>(gpl.word[i]) |
                             (static_cast<uint32_t>(gpl.shift[i]) << 16) |
                             (gpl.full[i] ? kFullBit : 0u) |
                             (sc >= 0 ? kScBit : 0u)));
    psc[i] = sc;
  }
  // this warp's part
  int32_t* base = sm + 4 * w + pad4(w) +
                  wid * warp_words(RW, P, ws, bws, k, pw);
  uint8_t* list = reinterpret_cast<uint8_t*>(base);
  uint8_t* rb = reinterpret_cast<uint8_t*>(base + pad4((RW + 3) / 4));
  int32_t* lanes = base + 2 * pad4((RW + 3) / 4);
  int32_t* blanes = lanes + pad4(P * ws + 3);
  int32_t* kbuf = blanes + (bws ? pad4(P * bws + 3) : 0);
  int32_t* pbuf = kbuf + pad4(RW * k + 3);
  __syncthreads();  // the plan
  const int per = RW / 32;  // rows a lane lists
  const int64_t ntiles = (n + RW - 1) / RW;
  const int64_t nw = static_cast<int64_t>(gridDim.x) * warps;
  bool any_bad = false;
  int64_t tile = static_cast<int64_t>(blockIdx.x) * warps + wid;
  uint32_t bits = tile < ntiles ? valid_bits(valid, tile * RW, n, per, lane)
                                : 0u;
  for (; tile < ntiles; tile += nw) {
    const int64_t r0 = tile * RW;
    const int nt = static_cast<int>(n - r0 < RW ? n - r0 : RW);
    // the warp's next tile's validity, in flight while this one is done
    const uint32_t next = tile + nw < ntiles
                              ? valid_bits(valid, (tile + nw) * RW, n, per,
                                           lane)
                              : 0u;
    // list the tile's valid rows in row order: a scan of the lanes'
    // counts
    const int cnt = __popc(bits);
    int x = cnt;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    const int nv = __shfl_sync(kFull, x, 31);
    int u = x - cnt;
    for (int j = 0; j < per; ++j) {
      const int r = lane * per + j;
      if (r >= nt) break;
      const bool v = (bits >> j) & 1u;
      rb[r] = v ? 1 : 0;
      if (v) list[u++] = static_cast<uint8_t>(r);
    }
    __syncwarp();
    int32_t* kt = kbuf + phase4(keys + r0 * k);
    int32_t* pt = pbuf + phase4(packed + r0 * pw);
    // the listed rows, P at a time: gather their lanes (one run of 16-byte
    // copies when they are one run of rows), pack and key
    for (int c0 = 0; c0 < nv; c0 += P) {
      const int m = nv - c0 < P ? nv - c0 : P;
      const int first = list[c0];
      int lo = 0, bo = 0, ls = ws, bs = bws;
      if (list[c0 + m - 1] - first == m - 1) {
        lo = run_in(rows + (r0 + first) * w, m * w, lanes, lane);
        ls = w;
        if (BASIS != kStored) {
          bo = run_in(basis + (r0 + first) * bwl, m * bwl, blanes, lane);
          bs = bwl;
        }
      } else {
        rows_in(rows, r0, list + c0, m, w, ws, lanes, lane);
        if (BASIS != kStored)
          rows_in(basis, r0, list + c0, m, bwl, bws, blanes, lane);
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncwarp();
      for (int i = lane; i < m; i += 32) {
        const int r = list[c0 + i];
        int32_t* prow = pt + r * pw;
        KeyAcc<FP> key(kt + r * k);
        const int32_t* lr = lanes + lo + i * ls;
        const int32_t* br = blanes + bo + i * bs;
        bool bad_row, bad_key = false;
        if (BASIS == kPackOther) {  // the row and its orbit minimum
          const int32_t* const rp[2] = {lr, br};
          bool bad[2];
          pack_rows<2>(rp, w, pw, pq, psc, bad,
                       [&](int j, const uint32_t* y) {
                         prow[j] = static_cast<int32_t>(y[0]);
                         key.put(y[1]);
                       });
          bad_row = bad[0];
          bad_key = bad[1];
        } else {
          const int32_t* const rp[1] = {lr};
          bool bad[1];
          pack_rows<1>(rp, w, pw, pq, psc, bad,
                       [&](int j, const uint32_t* y) {
                         prow[j] = static_cast<int32_t>(y[0]);
                         if (BASIS == kStored) key.put(y[0]);
                       });
          bad_row = bad[0];
          if (BASIS == kRaw)
            for (int j = 0; j < bw; ++j) key.put(static_cast<uint32_t>(br[j]));
        }
        key.finish();
        if (bad_row) rb[r] = 3;
        any_bad |= bad_row || bad_key;
      }
      __syncwarp();
    }
    rows_out(kt, nt * k, k, rb, true, keys + r0 * k, lane);
    rows_out(pt, nt * pw, pw, rb, false, packed + r0 * pw, lane);
    if (row_ovf) {
      for (int r = lane; r < nt; r += 32) row_ovf[r0 + r] = rb[r] == 3;
    }
    __syncwarp();
    bits = next;
  }
  // the overflow flag: OR into the workspace, the last block reads it
  // out and leaves both words at zero
  if (__syncthreads_or(any_bad) && t == 0) atomicOr(acc, 1u);
  if (t == 0) {
    __threadfence();
    if (atomicAdd(acc + 1, 1u) == gridDim.x - 1) {
      __threadfence();
      *ovf_out = atomicExch(acc, 0u) != 0;
      atomicExch(acc + 1, 0u);
    }
  }
}

template <bool FP, int BASIS>
cudaError_t launch(int warps, int RW, int P, int smem, cudaStream_t stream,
                   const int32_t* rows, const bool* valid, const Plan& pl,
                   const int32_t* basis, int bw, int32_t* keys,
                   int32_t* packed, bool* ovf_out, bool* row_ovf,
                   uint32_t* acc, int64_t n, int w, int pw) {
  cudaError_t err;
  if (smem > kSmemDefault) {
    err = cudaFuncSetAttribute(keys_of_kernel<FP, BASIS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return fail(err);
  }
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return fail(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return fail(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, keys_of_kernel<FP, BASIS>, 32 * warps, smem);
  if (err != cudaSuccess) return fail(err);
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t tiles = (n + RW - 1) / RW;
  int64_t blocks = (tiles + warps - 1) / warps;
  if (blocks > static_cast<int64_t>(per_sm) * sms)
    blocks = static_cast<int64_t>(per_sm) * sms;
  if (blocks < 1) blocks = 1;  // n == 0: one block writes the flag
  keys_of_kernel<FP, BASIS><<<static_cast<unsigned>(blocks), 32 * warps,
                              smem, stream>>>(rows, valid, pl, basis, bw,
                                              keys, packed, ovf_out, row_ovf,
                                              acc, n, w, pw, RW, P);
  return cudaGetLastError();
}

}  // namespace

// K2 over n rows of w lanes: keys [n, K], packed [n, pw], the overflow
// flag (one bool) and, when row_ovf is not null, the per-row flags of the
// stored rows.  `warps` warps a block (1 to 8), RW rows a warp's tile
// (a multiple of 32 up to 256), P listed rows a pass (1 to RW) and smem
// bytes of
// shared memory a block (kernels/ops.py keys_geometry); acc is the
// workspace's word 0 (two uint32, zero between calls).
extern "C" cudaError_t jmc_keys_of(
    const int32_t* rows, const bool* valid, const int32_t* word,
    const int32_t* shift, const int32_t* mask, const int32_t* bias,
    const int32_t* allowed, const int32_t* full, const int32_t* sent_code,
    const int32_t* basis, int32_t* keys, int32_t* packed, bool* ovf_out,
    bool* row_ovf, uint32_t* acc, int64_t n, int w, int pw, int fp_mode,
    int basis_kind, int bw, int warps, int RW, int P, int smem,
    cudaStream_t stream) {
  if (basis_kind < kStored || basis_kind > kRaw || n < 0 || w < 0 ||
      pw < 0 || bw < 0 || warps < 1 || warps > kThreads / 32 ||
      RW < 32 || RW > 256 || RW % 32 != 0 || P < 1 || P > RW || smem < 0)
    return cudaErrorInvalidValue;
  const Plan pl{word, shift, mask, bias, allowed, full, sent_code};
#define JMC_KEYS(FP, BASIS)                                               \
  launch<FP, BASIS>(warps, RW, P, smem, stream, rows, valid, pl, basis,  \
                    bw, keys, packed, ovf_out, row_ovf, acc, n, w, pw)
  if (fp_mode) {
    if (basis_kind == kStored) return JMC_KEYS(true, kStored);
    if (basis_kind == kPackOther) return JMC_KEYS(true, kPackOther);
    return JMC_KEYS(true, kRaw);
  }
  if (basis_kind == kStored) return JMC_KEYS(false, kStored);
  if (basis_kind == kPackOther) return JMC_KEYS(false, kPackOther);
  return JMC_KEYS(false, kRaw);
#undef JMC_KEYS
}
