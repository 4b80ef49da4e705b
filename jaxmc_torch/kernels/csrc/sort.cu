// K18 sort_keys: a stable lexicographic sort of int32 key rows with a
// row-index payload, as a least-significant-digit radix sort in onesweep
// form (Adinets & Merrill, "Onesweep: A Faster Least Significant Digit
// Radix Sort for GPUs", 2022); and its front_order site.
//
// Replaces: the stable multi-word sorts that the reference leaves to
// XLA's lax.sort: jaxmc/backend/bfs.py:178 _lsd_sort and :318-326 in
// _rank_merge (the candidate keys, every engine's merge: the level step
// at bfs.py:1814, the resident level and the mesh merge), :1830 the
// full-sort step's sort of seen + candidates, :1882 the level step's
// next-frontier order (comp4, num_keys=2: the front_order site below),
// jaxmc/backend/oracle.py:75 the preflight probe's 4-key sort and
// jaxmc/backend/mesh.py:739 the mesh's full-sort merge.
//
// Function: keys [n, k] int32, word 0 most significant, each word
// compared as a signed int32 -> skeys [n, k] (the rows in order) and
// sidx [n] int32 (each sorted row's index); equal rows keep their index
// order.  It equals lax.sort(cols + (arange,), num_keys=k,
// is_stable=True) on any input.
//
// Bound on the card: bytes.  Each key word read once; each key word and
// each index written once: n * (2k + 1) * 4 bytes.
//
// Design: one upsweep launch, np digit-pass launches (np = 4k), one
// clearing launch; nothing is read back to the host.
//   Digits are the bytes of the words, least significant first, the top
//   byte of each word with its sign bit flipped so that unsigned digit
//   order is signed order.
//   The tail key is the last row's.  Rows equal to it are equal to one
//   another, so they keep their index order and land as one block at
//   the number of rows below that key: pass 0 writes them straight to
//   the output and no later pass moves them.  This is right on any input
//   (only the last row, or every row, may equal it).  The engines' key
//   blocks end in their filler rows: the invalid key (1, SENTINEL, ...)
//   of the candidates that are not states, the resident accumulator's
//   unfilled SENTINEL rows; at the level's widest merge about 82% of the
//   rows are the tail key's, and the digit passes sort the others.
//   1 sort_upsweep_kernel: every row read once (4 rows a thread, their
//     loads in flight together); a byte a row that says whether it is
//     the tail key, the number of rows equal to and below that key, and
//     the histogram of each digit position over the other m rows, which
//     queue up in shared memory a warp at a time and are counted 32 at a
//     time (a warp whose rows share a word adds them with one atomic a
//     digit).  The block that finishes last (a done count) keeps the
//     positions whose digit varies over those m rows (a position whose
//     digit is one value on all of them cannot change their order),
//     writes each kept position's 256 bucket offsets into the plan, and
//     clears the histograms and counts.
//   2 sort_pass_kernel, launch j = 0 .. np-1: runs the plan's j-th kept
//     position, or exits when the plan has fewer (pass 0 always runs: it
//     also splits off the tail rows).  At most kPassBlocks blocks an SM
//     take tiles in ticket order (lookback.cuh take_ticket) until none is
//     left.  A tile (1,024 rows up to 2^21 rows, else 2,048; 4,096 in
//     pass 0) first loads every row's digit, then ranks its rows by digit
//     in index order, each warp with __match_any_sync over its rows; a
//     thread a digit finds that digit's global offset by a decoupled
//     look-back over per-tile, per-digit status words (32 bits: a state
//     and a count); each word column and then the index go through
//     shared memory in digit order, the next column's loads in flight
//     while one is written, so that each digit's rows are written as one
//     contiguous run.  Pass 0 reads the tail bytes and the words of the
//     other rows of the [n, k] keys, makes the indices and writes each
//     tile's run of tail rows' words flat (they are the tail key's); the
//     later passes read and write word columns ([k + 1][n] int32, two
//     buffers in turn).  The last kept pass writes skeys and sidx, its
//     rows below the tail key before the tail block and the others after
//     it.  A pass clears the status words of the pass before it.
//   3 sort_clear_kernel: clears the plan and both sets of status words.
// So the workspace words are zero between calls: nothing is kept across
// calls, and a call may be captured in a CUDA graph and replayed.  The
// launches past the plan's passes read the plan header and exit.
// What sets the time (PERF.md section 6): a tile's ranking, look-back
// and columns each take microseconds of latency, so a pass runs at
// about twice its bytes' bound over the other rows.
//
// Scratch: the word columns and the tail bytes, one allocation of the
// wrapper's.
//
// front_order (mode kFront, k = 1): the level step's next-frontier
// order.  Its one word is built in the upsweep and in pass 0 from the
// explore flags and the provenance: (1 - explore) << b | fmaj, with
// fmaj = (prov % fc) * a + prov / fc < 2^b; its last row is most often
// past the new count, so the tail key 1 << b (provenance 0, not
// explored), and it writes sidx alone.  np = ceil((b + 1) / 8): the
// digits above bit b are zero on every row.
//
// Limits: n < 2^30 (status counts are 30 bits); k * 4 KB of histograms
// in the upsweep's shared memory.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;  // jmc_lb::block_scan's block
constexpr int kWarps = kThreads / 32;
// rows a thread in a pass tile: 4 up to kSmallRows rows, else 8 (more
// tiles in flight for a small sort, fewer look-backs for a large one);
// the pass blocks an SM holds (its registers capped to fit them): a
// pass launches that many blocks an SM at most, each taking tiles
// until none is left; pass 0 of a large sort (most of its rows the tail
// key's, little work a row) takes tiles of kPass0Items rows a thread,
// kPass0Blocks an SM (measured on the card, PERF.md section 6)
constexpr int kSmallRows = 1 << 21;
constexpr int kPassBlocks = 6;
constexpr int kPass0Items = 16;
constexpr int kPass0Blocks = 4;
constexpr int kRadix = 256;
// the digits, then the tail key's bin (pass 0 only)
constexpr int kBins = kRadix + 1;
constexpr int kTailBin = kRadix;
// a lane with no row
constexpr uint32_t kDead = kBins;
constexpr uint32_t kNoSlot = 0xFFFFFFFFu;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kFlip = 0x80000000u;
constexpr int32_t kSentinel = 0x7FFFFFFF;
// status word: bits 31-30 the state (0 none, 1 the tile's count, 2 the
// inclusive prefix), bits 29-0 the count
constexpr uint32_t kAggregate = 1u << 30;
constexpr uint32_t kInclusive = 2u << 30;
constexpr uint32_t kCount = (1u << 30) - 1u;
// the upsweep: at least kUpRows rows a block, at most kUpBlocks blocks,
// kUpItems rows a thread at a time (their loads in flight together)
constexpr int64_t kUpRows = 4096;
constexpr int64_t kUpBlocks = 1024;
constexpr int kUpItems = 4;
constexpr int kSmemDefault = 47 * 1024;
constexpr int kSmemMax = 232448 - 1024;
constexpr int kKeys = 0;
constexpr int kFront = 1;

__host__ __device__ __forceinline__ int64_t pad4(int64_t w) {
  return (w + 3) & ~int64_t(3);
}

inline cudaError_t fail(cudaError_t err) {
  cudaGetLastError();
  return err;
}

// The words of the rows: kKeys reads keys [n, k]; kFront builds its one
// word from the explore flags and the provenance.
struct Src {
  const int32_t* keys;
  const bool* explore;
  const int64_t* prov;
  int64_t a, fc;
  int bits;
};

// The workspace, in 32-bit words from its start (the wrapper's zero
// words): the histograms [np][256], the counts (rows equal to the tail
// key, rows below it, the upsweep's done count, the passes' ticket),
// the plan (its header: kept positions, m, rows below, tail rows; the
// kept positions; their bucket offsets [np][256]) and two sets of
// status words [tiles][kBins].
struct Layout {
  int64_t hist, cnt, plan, digit, base, status0, status1, total;
};

// the rows of a pass tile for n rows
__host__ __device__ inline int tile_rows(int64_t n) {
  return kThreads * (n <= kSmallRows ? 4 : 8);
}

__host__ __device__ inline Layout layout(int64_t n, int np) {
  Layout l;
  const int64_t tiles = (n + tile_rows(n) - 1) / tile_rows(n);
  const int64_t set = pad4(tiles * kBins);
  l.hist = 0;
  l.cnt = l.hist + int64_t(np) * kRadix;
  l.plan = l.cnt + 4;
  l.digit = l.plan + 4;
  l.base = l.digit + pad4(np);
  l.status0 = l.base + int64_t(np) * kRadix;
  l.status1 = l.status0 + set;
  l.total = l.status1 + set;
  return l;
}

template <int MODE>
__device__ __forceinline__ int32_t word_of(const Src& s, int64_t r, int c,
                                           int k) {
  if (MODE == kKeys) return __ldg(s.keys + r * k + c);
  // prov < n < 2^30: 32-bit division
  const uint32_t p = static_cast<uint32_t>(__ldg(s.prov + r));
  const uint32_t fc = static_cast<uint32_t>(s.fc);
  const uint32_t fmaj = (p % fc) * static_cast<uint32_t>(s.a) + p / fc;
  return static_cast<int32_t>((s.explore[r] ? 0u : (1u << s.bits)) | fmaj);
}

// word c of the tail key: the last row's
template <int MODE>
__device__ __forceinline__ int32_t tail_word(const Src& s, int64_t n, int c,
                                             int k) {
  return word_of<MODE>(s, n - 1, c, k);
}

// cmp, or where it is 0 (the words so far equal), -1, 0 or 1 as w is
// below, equal to or above t
__device__ __forceinline__ int cmp_on(int cmp, int32_t w, int32_t t) {
  return cmp ? cmp : (w < t ? -1 : (w > t ? 1 : 0));
}

__device__ __forceinline__ uint32_t digit_of(int32_t w, int shift) {
  return ((static_cast<uint32_t>(w) ^ kFlip) >> shift) & 0xFFu;
}

__device__ __forceinline__ uint32_t load32(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store32(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The four digits of word w (word c of k) into the block's histograms
// (h: position 0's) for each lane of `act`: a warp whose lanes of `act`
// share the word adds them with one atomic a digit.
__device__ __forceinline__ void warp_count(uint32_t* h, int32_t w, int c,
                                           int k, int np, unsigned act) {
  const int lane = threadIdx.x & 31, lead = __ffs(act) - 1;
  const bool mine = (act >> lane) & 1u;
  const int p0 = 4 * (k - 1 - c);
  const int nb = np - p0 < 4 ? np - p0 : 4;
  const int32_t w0 = __shfl_sync(kFull, w, lead);
  if (__all_sync(kFull, !mine || w == w0)) {
    if (lane == lead)
      for (int b = 0; b < nb; ++b)
        atomicAdd(h + (p0 + b) * kRadix + digit_of(w, 8 * b),
                  static_cast<uint32_t>(__popc(act)));
  } else if (mine) {
    for (int b = 0; b < nb; ++b)
      atomicAdd(h + (p0 + b) * kRadix + digit_of(w, 8 * b), 1u);
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    sort_upsweep_kernel(Src src, int64_t n, int k, int np,
                        int64_t per_block, uint8_t* __restrict__ tails,
                        uint32_t* ws) {
  extern __shared__ uint32_t s_hist[];  // [np][kRadix]
  __shared__ uint32_t s_cnt[2];
  __shared__ int s_warp[kWarps];
  __shared__ int s_last;
  // each warp's rows that are not the tail key, waiting to be counted 32
  // at a time (offsets from r0)
  __shared__ int32_t s_queue[kWarps][64];
  const Layout L = layout(n, np);
  uint32_t* hist = ws + L.hist;
  uint32_t* cnt = ws + L.cnt;
  const int t = threadIdx.x;
  for (int i = t; i < np * kRadix; i += kThreads) s_hist[i] = 0;
  if (t < 2) s_cnt[t] = 0;
  __syncthreads();
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t r1 = r0 + per_block < n ? r0 + per_block : n;
  uint32_t eq = 0, below = 0;
  const int lane = t & 31;
  int32_t* queue = s_queue[t >> 5];
  int queued = 0;  // the same in every lane of a warp
  // the digits of the queue's row at `off` for each lane of act
  auto count_row = [&](int32_t off, unsigned act) {
    for (int c = 0; c < k; ++c)
      warp_count(s_hist,
                 (act >> lane) & 1u ? word_of<MODE>(src, r0 + off, c, k) : 0,
                 c, k, np, act);
  };
  for (int64_t b0 = r0; b0 < r1; b0 += kThreads * kUpItems) {
    // each row against the tail key, word by word, the rows' loads of a
    // word together
    int cmp[kUpItems];
#pragma unroll
    for (int q = 0; q < kUpItems; ++q) cmp[q] = 0;
    for (int c = 0; c < k; ++c) {
      const int32_t tw = tail_word<MODE>(src, n, c, k);
#pragma unroll
      for (int q = 0; q < kUpItems; ++q) {
        const int64_t r = b0 + q * kThreads + t;
        cmp[q] = cmp_on(cmp[q], r < r1 ? word_of<MODE>(src, r, c, k) : tw,
                        tw);
      }
    }
#pragma unroll
    for (int q = 0; q < kUpItems; ++q) {
      const int64_t r = b0 + q * kThreads + t;
      if (r < r1) {
        eq += cmp[q] == 0;
        below += cmp[q] < 0;
        tails[r] = cmp[q] == 0;
      }
      // the rows that are not the tail key join the warp's queue (rows
      // past r1 compare equal); 32 of them are counted at a time, so that
      // every lane of the counting warp has a row
      const unsigned act = __ballot_sync(kFull, cmp[q] != 0);
      if (cmp[q] != 0)
        queue[queued + __popc(act & ((1u << lane) - 1u))] =
            static_cast<int32_t>(r - r0);
      queued += __popc(act);
      __syncwarp();
      if (queued >= 32) {
        count_row(queue[lane], kFull);
        const int32_t more = lane < queued - 32 ? queue[32 + lane] : 0;
        __syncwarp();
        if (lane < queued - 32) queue[lane] = more;
        __syncwarp();
        queued -= 32;
      }
    }
  }
  if (queued) count_row(lane < queued ? queue[lane] : 0, (1u << queued) - 1u);
  eq = jmc_lb::warp_sum(eq);
  below = jmc_lb::warp_sum(below);
  if ((t & 31) == 0) {
    if (eq) atomicAdd(s_cnt, eq);
    if (below) atomicAdd(s_cnt + 1, below);
  }
  __syncthreads();
  for (int i = t; i < np * kRadix; i += kThreads)
    if (s_hist[i]) atomicAdd(hist + i, s_hist[i]);
  if (t == 0) {
    if (s_cnt[0]) atomicAdd(cnt, s_cnt[0]);
    if (s_cnt[1]) atomicAdd(cnt + 1, s_cnt[1]);
  }
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(cnt + 2, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  // the plan: every block's counts are in
  __threadfence();
  const uint32_t ntail = __ldcg(cnt), nless = __ldcg(cnt + 1);
  const uint32_t m = static_cast<uint32_t>(n) - ntail;
  uint32_t* plan = ws + L.plan;
  uint32_t* digit = ws + L.digit;
  uint32_t* base = ws + L.base;
  int kept = 0;
  for (int p = 0; p < np; ++p) {
    const uint32_t h = __ldcg(hist + p * kRadix + t);
    hist[p * kRadix + t] = 0;
    if (__syncthreads_or(h == m)) continue;  // one digit on every row
    int total;
    base[kept * kRadix + t] = static_cast<uint32_t>(
        jmc_lb::block_scan(static_cast<int>(h), s_warp, &total));
    if (t == 0) digit[kept] = p;
    ++kept;
    __syncthreads();  // s_warp is the next scan's
  }
  if (t == 0) {
    plan[0] = kept;
    plan[1] = m;
    plan[2] = nless;
    plan[3] = ntail;
    cnt[0] = 0;
    cnt[1] = 0;
    cnt[2] = 0;
  }
}

// One digit's look-back for tile `tile` whose count of that digit is
// agg (st: the digit's word of tile 0; a tile's words kBins apart):
// tile 0 publishes base + agg, each other tile its count, then sums the
// earlier tiles' words back to the nearest inclusive prefix.  Returns
// the digit's first output position in this tile.
__device__ __forceinline__ uint32_t look_back_bin(uint32_t* st, int tile,
                                                  uint32_t agg,
                                                  uint32_t base) {
  if (tile == 0) {
    store32(st, kInclusive | (base + agg));
    return base;
  }
  uint32_t* mine = st + static_cast<int64_t>(tile) * kBins;
  store32(mine, kAggregate | agg);
  uint32_t excl = 0;
  for (int p = tile - 1;; --p) {
    const uint32_t* w = st + static_cast<int64_t>(p) * kBins;
    uint32_t v = load32(w);
    while ((v >> 30) == 0) {
      __nanosleep(20);
      v = load32(w);
    }
    excl += v & kCount;
    if ((v >> 30) == 2) break;
  }
  store32(mine, kInclusive | (excl + agg));
  return excl;
}

// One tile of launch j: rank its rows by digit (the tail rows last, in
// pass 0), find each digit's output position by the look-back, write
// each column through shared memory in digit order.
template <int MODE, int ITEMS>
__device__ __forceinline__ void sort_tile(
    int j, const Src& src, const int32_t* __restrict__ from,
    int32_t* __restrict__ to, int32_t* __restrict__ skeys,
    int32_t* __restrict__ sidx, int64_t n, int k,
    const uint8_t* __restrict__ tails, uint32_t* status,
    const uint32_t* bases, uint32_t nless, uint32_t ntail, bool last, int dp,
    int dcol, int dsh, int w0, int tile, int64_t r0, int nt,
    uint32_t (*s_wc)[kBins], uint32_t* s_tot, uint32_t* s_lex,
    uint32_t* s_gb, int32_t* s_col, uint32_t* s_pos, int* s_warp) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int i = t; i < kWarps * kBins; i += kThreads) (&s_wc[0][0])[i] = 0;
  __syncthreads();
  uint32_t br[ITEMS];  // bin << 16 | rank among the warp's rows of the bin
  // every row's bin first (its loads in flight together), then the ranks
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const int i = w0 + q * 32 + lane;
    const int64_t r = r0 + i;
    uint32_t b = kDead;
    if (i < nt) {
      if (j == 0 && tails[r]) {
        b = kTailBin;
      } else {
        b = 0;
        if (dp >= 0)
          b = digit_of(j == 0 ? word_of<MODE>(src, r, dcol, k)
                              : from[dcol * n + r],
                       dsh);
      }
    }
    br[q] = b;
  }
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const uint32_t b = br[q];
    const bool live = b != kDead;
    const unsigned peers = __match_any_sync(kFull, b);
    const int lead = __ffs(peers) - 1;
    uint32_t prior = 0;
    if (live && lane == lead) {
      prior = s_wc[warp][b];
      s_wc[warp][b] = prior + __popc(peers);
    }
    prior = __shfl_sync(kFull, prior, lead);
    br[q] = (b << 16) | (prior + __popc(peers & ((1u << lane) - 1u)));
    __syncwarp();
  }
  __syncthreads();
  for (int d = t; d < kBins; d += kThreads) {
    uint32_t run = 0;
    for (int v = 0; v < kWarps; ++v) {
      const uint32_t c = s_wc[v][d];
      s_wc[v][d] = run;
      run += c;
    }
    s_tot[d] = run;
  }
  __syncthreads();
  {
    int total;
    s_lex[t] = static_cast<uint32_t>(
        jmc_lb::block_scan(static_cast<int>(s_tot[t]), s_warp, &total));
    if (t == 0) s_lex[kTailBin] = static_cast<uint32_t>(total);
  }
  const int nb = j == 0 ? kBins : kRadix;
  for (int d = t; d < nb; d += kThreads) {
    const uint32_t base = d == kTailBin ? nless : (dp >= 0 ? bases[d] : 0u);
    s_gb[d] = look_back_bin(status + d, tile, s_tot[d], base);
  }
  __syncthreads();
  // each row's slot in digit order and its output position
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const uint32_t b = br[q] >> 16;
    if (b == kDead) {
      br[q] = kNoSlot;
      continue;
    }
    const uint32_t rk = (br[q] & 0xFFFFu) + s_wc[warp][b];
    uint32_t p = s_gb[b] + rk;
    if (last && b != kTailBin && p >= nless) p += ntail;
    const uint32_t slot = s_lex[b] + rk;
    s_pos[slot] = p;
    br[q] = slot;
  }
  // the slots from ntl on hold the tail rows (pass 0): their output is
  // one run, and its words the tail key's, written flat
  const int ntl = static_cast<int>(s_lex[kTailBin]);
  if (j == 0 && skeys && ntl < nt) {
    int32_t* run = skeys + static_cast<int64_t>(s_gb[kTailBin]) * k;
    for (int f = t; f < (nt - ntl) * k; f += kThreads)
      run[f] = tail_word<MODE>(src, n, f % k, k);
  }
  // the columns: the words (of the slots below ntl), then the index
  // (front_order's last pass: the index alone); each column's words are
  // loaded while the column before it is written out
  const int c0 = last && !skeys ? k : 0;
  auto load_col = [&](int c, int32_t* v) {
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      v[q] = 0;
      if (br[q] == kNoSlot || (c < k && br[q] >= static_cast<uint32_t>(ntl)))
        continue;
      const int64_t r = r0 + w0 + q * 32 + lane;
      if (c == k)
        v[q] = j == 0 ? static_cast<int32_t>(r) : from[k * n + r];
      else
        v[q] = j == 0 ? word_of<MODE>(src, r, c, k) : from[c * n + r];
    }
  };
  int32_t v[ITEMS], vn[ITEMS];
  load_col(c0, vn);
  for (int c = c0; c <= k; ++c) {
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) v[q] = vn[q];
    __syncthreads();  // s_col's last column is written out
#pragma unroll
    for (int q = 0; q < ITEMS; ++q)
      if (br[q] != kNoSlot) s_col[br[q]] = v[q];
    if (c < k) load_col(c + 1, vn);
    __syncthreads();
    for (int i = t; i < (c < k ? ntl : nt); i += kThreads) {
      const int64_t p = s_pos[i];
      const int32_t val = s_col[i];
      if (last || i >= ntl) {
        if (c == k)
          sidx[p] = val;
        else if (skeys)
          skeys[p * k + c] = val;
      } else {
        to[c * n + p] = val;
      }
    }
  }
}

// Launch j: the plan's j-th kept digit position over the rows of the
// pass (pass 0: all n rows, read from the source, the tail rows written
// straight to the output; later passes: the m other rows, read from the
// word columns `from`).  Non-tail rows go to the word columns `to`, or
// to skeys and sidx when this is the plan's last pass.
template <int MODE, int ITEMS, int BLOCKS>
__global__ void __launch_bounds__(kThreads, BLOCKS)
    sort_pass_kernel(int j, Src src, const int32_t* __restrict__ from,
                     int32_t* __restrict__ to, int32_t* __restrict__ skeys,
                     int32_t* __restrict__ sidx, int64_t n, int k, int np,
                     const uint8_t* __restrict__ tails,
                     uint32_t* ws) {
  __shared__ uint32_t s_wc[kWarps][kBins];  // each warp's rows by bin
  __shared__ uint32_t s_tot[kBins];         // the tile's rows by bin
  __shared__ uint32_t s_lex[kBins];         // the tile's first slot by bin
  __shared__ uint32_t s_gb[kBins];          // the first output position
  constexpr int kTile = kThreads * ITEMS;
  __shared__ int32_t s_col[kTile];          // a column in slot order
  __shared__ uint32_t s_pos[kTile];         // each slot's output position
  __shared__ int s_warp[kWarps];
  __shared__ int s_tile;
  const Layout L = layout(n, np);
  const uint32_t* plan = ws + L.plan;
  const uint32_t kept = plan[0], m = plan[1], nless = plan[2],
                 ntail = plan[3];
  const int npass = kept ? static_cast<int>(kept) : 1;
  if (j >= npass) return;
  uint32_t* status = ws + ((j & 1) ? L.status1 : L.status0);
  if (j >= 1) {  // the pass before: its set is the next pass's
    uint32_t* prev = ws + ((j & 1) ? L.status0 : L.status1);
    const int64_t rows_prev = j == 1 ? n : m;
    const int64_t words = (rows_prev + kTile - 1) / kTile * kBins;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads +
                     threadIdx.x;
         i < words; i += static_cast<int64_t>(gridDim.x) * kThreads)
      prev[i] = 0;
  }
  const int64_t rows = j == 0 ? n : m;
  const int tiles = static_cast<int>((rows + kTile - 1) / kTile);
  const bool last = j == npass - 1;
  const int dp = kept ? static_cast<int>(ws[L.digit + j]) : -1;
  const uint32_t* bases = ws + L.base + static_cast<int64_t>(j) * kRadix;
  const int dcol = dp < 0 ? 0 : k - 1 - dp / 4;
  const int dsh = dp < 0 ? 0 : 8 * (dp % 4);
  // row i of a tile is warp i / (32 ITEMS)'s, item (i / 32) % ITEMS,
  // lane i % 32, so a warp's items walk its rows in order
  const int w0 = (threadIdx.x >> 5) * 32 * ITEMS;
  for (;;) {
    // every block takes one ticket past the last tile: the last of those
    // sets the counter back to 0
    const int tile = jmc_lb::take_ticket(ws + L.cnt + 3, tiles + gridDim.x,
                                         &s_tile);
    if (tile >= tiles) return;
    const int64_t r0 = static_cast<int64_t>(tile) * kTile;
    const int nt = static_cast<int>(rows - r0 < kTile ? rows - r0 : kTile);
    sort_tile<MODE, ITEMS>(j, src, from, to, skeys, sidx, n, k,
                           tails, status, bases, nless, ntail, last, dp,
                           dcol, dsh, w0, tile, r0, nt, s_wc, s_tot, s_lex,
                           s_gb, s_col, s_pos, s_warp);
  }
}

// the plan and both sets of status words back to zero
__global__ void __launch_bounds__(kThreads)
    sort_clear_kernel(uint32_t* words, int64_t nw) {
  uint4* v = reinterpret_cast<uint4*>(words);
  const int64_t nv = nw >> 2;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < nv; i += stride)
    v[i] = make_uint4(0u, 0u, 0u, 0u);
}

template <int MODE>
cudaError_t launch_all(const Src& src, int32_t* skeys, int32_t* sidx,
                       int32_t* buf, uint32_t* ws, int64_t n, int k, int np,
                       cudaStream_t stream) {
  // the pass blocks: kPassBlocks an SM, fewer for fewer tiles
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return fail(err);
  int64_t grid = (n + tile_rows(n) - 1) / tile_rows(n);
  if (grid > int64_t(kPassBlocks) * sms) grid = int64_t(kPassBlocks) * sms;
  int64_t up = (n + kUpRows - 1) / kUpRows;
  if (up > kUpBlocks) up = kUpBlocks;
  const int64_t per = (n + up - 1) / up;
  const int smem = np * kRadix * 4;
  if (smem > kSmemDefault) {
    err = cudaFuncSetAttribute(sort_upsweep_kernel<MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return fail(err);
  }
  int32_t* cols[2] = {buf, buf + static_cast<int64_t>(k + 1) * n};
  uint8_t* tails = reinterpret_cast<uint8_t*>(buf + 2 * (k + 1) * n);
  sort_upsweep_kernel<MODE><<<static_cast<unsigned>(up), kThreads, smem,
                              stream>>>(src, n, k, np, per, tails,
                                        ws);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
#define JMC_PASS(I, B, G)                                                  \
  sort_pass_kernel<MODE, I, B><<<static_cast<unsigned>(G), kThreads, 0,    \
                                 stream>>>(j, src, cols[(j + 1) & 1],      \
                                           cols[j & 1], skeys, sidx, n, k, \
                                           np, tails, ws)
  for (int j = 0; j < np; ++j) {
    if (tile_rows(n) == 4 * kThreads) {
      JMC_PASS(4, kPassBlocks, grid);
    } else if (j == 0) {
      int64_t g0 = (n + kPass0Items * kThreads - 1) / (kPass0Items * kThreads);
      if (g0 > int64_t(kPass0Blocks) * sms) g0 = int64_t(kPass0Blocks) * sms;
      JMC_PASS(kPass0Items, kPass0Blocks, g0);
    } else {
      JMC_PASS(8, kPassBlocks, grid);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
#undef JMC_PASS
  const Layout L = layout(n, np);
  const int64_t nw = L.total - L.plan;
  int64_t cgrid = (nw / 4 + kThreads - 1) / kThreads;
  if (cgrid > 1024) cgrid = 1024;
  if (cgrid < 1) cgrid = 1;
  sort_clear_kernel<<<static_cast<unsigned>(cgrid), kThreads, 0, stream>>>(
      ws + L.plan, nw);
  return cudaGetLastError();
}

}  // namespace

// the workspace's 32-bit words for n rows and np digit positions
extern "C" int64_t jmc_sort_workspace_words(int64_t n, int np) {
  return layout(n, np).total;
}

// K18 over keys [n, k] (mode 0) or front_order's word (mode 1: explore
// [n], prov [n] int64, a, fc, bits; k = 1; skeys null): skeys [n, k]
// and sidx [n]; buf the word columns, 2 (k + 1) n int32, then the tail
// bytes, n; ws the workspace, zero between calls, of
// jmc_sort_workspace_words(n, np) words from a 16-byte boundary.  np
// digit positions (4k for keys; front_order ceil((bits + 1) / 8)).  np
// + 2 launches.
extern "C" cudaError_t jmc_sort_keys(const int32_t* keys, const bool* explore,
                                     const int64_t* prov, int32_t* skeys,
                                     int32_t* sidx, int32_t* buf,
                                     uint32_t* ws, int64_t n, int k, int np,
                                     int mode, int64_t a,
                                     int64_t fc, int bits,
                                     cudaStream_t stream) {
  if (n < 1 || n >= (int64_t(1) << 30) || k < 1 || np < 1 || np > 4 * k ||
      np * kRadix * 4 > kSmemMax ||
      (reinterpret_cast<uintptr_t>(ws) & 15) != 0)
    return cudaErrorInvalidValue;
  Src src{keys, explore, prov, a, fc, bits};
  if (mode == kKeys) {
    if (!keys || !skeys || np != 4 * k) return cudaErrorInvalidValue;
    return launch_all<kKeys>(src, skeys, sidx, buf, ws, n, k, np, stream);
  }
  if (mode != kFront || k != 1 || !explore || !prov || a < 1 || fc < 1 ||
      bits < 0 || bits > 30 || np > 4)
    return cudaErrorInvalidValue;
  return launch_all<kFront>(src, nullptr, sidx, buf, ws, n, k, np, stream);
}
