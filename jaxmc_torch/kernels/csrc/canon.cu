// K5 canon_rows: each valid row replaced by the lexicographic minimum of
// its SYMMETRY orbit; invalid rows pass through.
//
// Replaces: jaxmc/compile/symmetry2.py:272 build_canon2 / :321 canon_row
// (one unrolled jnp transform per non-identity permutation, each a chain
// of per-segment gathers, value-table lookups, guarded selects and
// _lex_sort_rows sorts, then a where(lex_lt(cand, best)) per row, all
// vmapped by XLA), called from jaxmc/backend/bfs.py:1584 _keys_of.
//
// The program: compile/symmetry2.py flattens each permutation's segment
// transforms into an int32 table (layout in that module's docstring):
// per output lane a list of alternatives (conditions on input lanes,
// source lane, value table or not), the first whose conditions hold
// wins; then sort blocks (growset and kvtable rows, stable by their key
// lanes, signed order), inner ones first.  A permutation's lane ops
// come in increasing output lane.  One kernel serves every layout:
// nothing is generated per permutation.
//
// Bound on the card: bytes for few permutations, operations for many.
// Compulsory traffic is one read of every row (N*W*4), one byte of
// validity each and one write of every row (N*W*4); the operations are
// about P*W*(alternatives + compare) integer steps per valid row.
//
// Design: the orbit minimum stays on chip.  A block of T threads walks
// tiles of T rows (grid-stride, as many blocks as fit the SMs).  A tile
// comes into shared memory with 16-byte loads at the odd row stride
// w | 1 (a thread's lane of neighbouring rows in different banks), its
// valid rows are listed (a shared counter) and thread t canonicalises
// the t-th of them there, so a warp holds valid rows only (a level's
// candidate block is mostly invalid rows), and the tile goes back out
// with 16-byte stores.  A block first packs each lane op whose one
// alternative has no condition (the common case: a permuted lane,
// perhaps through the value table) into one word of shared memory, so
// such a lane costs one read of the program, not six.  The running minimum, and
// the candidate when the program has sort blocks, are shared memory
// laid out [w][T], so a lane index the program gives at run time costs
// no bank conflict.  A permutation none of whose sort blocks
// applies to the row builds its candidate lane by lane in order and
// compares each lane as it is made: it stops at the first lane above
// the minimum's, and from the first lane below writes the rest straight
// into the minimum (the first differing lane decides).  A permutation
// whose sort blocks apply builds the whole candidate, sorts it (stable
// insertion sorts over at most cap rows), then compares.  The program
// (a few KB) is staged in shared memory when it fits beside the tile.
// The wrapper picks T and the staging from w and the program's size
// (kernels/ops.py canon_geometry): no device memory besides the rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kSentinel = 0x7FFFFFFF;
constexpr int kMaxThreads = 256;

struct Prog {
  int P, U, W;
  const int32_t *pl, *lops, *alts, *conds, *ps, *sorts, *tabs;
};

__device__ inline Prog read_prog(const int32_t* b) {
  Prog p;
  p.P = b[0];
  p.U = b[1];
  p.W = b[2];
  p.pl = b + b[3];
  p.lops = b + b[4];
  p.alts = b + b[5];
  p.conds = b + b[6];
  p.ps = b + b[7];
  p.sorts = b + b[8];
  p.tabs = b + b[9];
  return p;
}

__device__ inline bool conds_hold(const Prog& pg, const int32_t* in,
                                  int c0, int nc) {
  for (int c = c0; c < c0 + nc; ++c) {
    const int32_t v = in[pg.conds[3 * c]];
    const int op = pg.conds[3 * c + 1];
    const int32_t k = pg.conds[3 * c + 2];
    if (op == 0 ? !(v > k) : !(v == k)) return false;
  }
  return true;
}

// lane op l's value: its first alternative whose conditions hold, else
// the input lane o
__device__ inline int32_t lane_value(const Prog& pg, const int32_t* in,
                                     const int32_t* tab, int l, int o) {
  const int a0 = pg.lops[3 * l + 1];
  const int na = pg.lops[3 * l + 2];
  for (int a = a0; a < a0 + na; ++a) {
    const int32_t* al = pg.alts + 4 * a;
    if (!conds_hold(pg, in, al[2], al[3])) continue;
    int32_t v = in[al[0]];
    if (al[1] && v != kSentinel) {
      const int32_t i = v < 0 ? 0 : (v >= pg.U ? pg.U - 1 : v);
      v = tab[i];
    }
    return v;
  }
  return in[o];
}

// a packed lane op: its output lane (bits 0-14), and for one
// unconditional alternative its source lane (15-29) and table flag
// (30); bit 31 marks the others, which take lane_value
constexpr uint32_t kLaneBits = 0x7FFFu;
constexpr uint32_t kTabBit = 1u << 30;
constexpr uint32_t kGeneral = 1u << 31;

__device__ inline uint32_t pack_lane_op(const Prog& pg, int l) {
  const uint32_t o = static_cast<uint32_t>(pg.lops[3 * l]);
  const int a0 = pg.lops[3 * l + 1];
  if (pg.lops[3 * l + 2] != 1 || pg.alts[4 * a0 + 3] != 0) return o | kGeneral;
  return o | (static_cast<uint32_t>(pg.alts[4 * a0]) << 15) |
         (pg.alts[4 * a0 + 1] ? kTabBit : 0u);
}

// the orbit minimum of row `in` (shared, stride 1), written back over
// it; cand and best are lane o at [o * T] (shared); fast[l] is lane op
// l packed
__device__ void canon_row(const Prog& pg, const uint32_t* fast, int32_t* in,
                          int32_t* cand, int32_t* best, int T, int w) {
  for (int o = 0; o < w; ++o) best[o * T] = in[o];
  for (int p = 0; p < pg.P; ++p) {
    const int32_t* tab = pg.tabs + static_cast<int64_t>(p) * pg.U;
    const int l0 = pg.pl[p], l1 = pg.pl[p + 1];
    bool sorts = false;
    for (int s = pg.ps[p]; s < pg.ps[p + 1] && !sorts; ++s)
      sorts = conds_hold(pg, in, pg.sorts[6 * s + 4], pg.sorts[6 * s + 5]);
    if (!sorts) {
      // compare as the candidate is built
      int l = l0;
      uint32_t f = l < l1 ? fast[l] : 0u;
      int next = l < l1 ? static_cast<int>(f & kLaneBits) : w;
      bool less = false;
      for (int o = 0; o < w; ++o) {
        int32_t v;
        if (o == next) {
          if (f & kGeneral) {
            v = lane_value(pg, in, tab, l, o);
          } else {
            v = in[(f >> 15) & kLaneBits];
            if ((f & kTabBit) && v != kSentinel)
              v = tab[v < 0 ? 0 : (v >= pg.U ? pg.U - 1 : v)];
          }
          ++l;
          f = l < l1 ? fast[l] : 0u;
          next = l < l1 ? static_cast<int>(f & kLaneBits) : w;
        } else {
          v = in[o];
        }
        if (!less) {
          const int32_t b = best[o * T];
          if (v > b) break;
          less = v < b;
        }
        if (less) best[o * T] = v;
      }
      continue;
    }
    for (int o = 0; o < w; ++o) cand[o * T] = in[o];
    for (int l = l0; l < l1; ++l) {
      const int o = pg.lops[3 * l];
      cand[o * T] = lane_value(pg, in, tab, l, o);
    }
    for (int s = pg.ps[p]; s < pg.ps[p + 1]; ++s) {
      const int32_t* sb = pg.sorts + 6 * s;
      if (!conds_hold(pg, in, sb[4], sb[5])) continue;
      const int off = sb[0], nrow = sb[1], rw = sb[2], kc = sb[3];
      // stable insertion sort of nrow rows of rw lanes by kc lanes
      for (int i = 1; i < nrow; ++i) {
        for (int j = i; j > 0; --j) {
          const int a = off + j * rw, b = off + (j - 1) * rw;
          int cmp = 0;
          for (int c = 0; c < kc && cmp == 0; ++c) {
            const int32_t x = cand[(a + c) * T];
            const int32_t y = cand[(b + c) * T];
            cmp = (x < y) ? -1 : (x > y ? 1 : 0);
          }
          if (cmp >= 0) break;
          for (int c = 0; c < rw; ++c) {
            const int32_t x = cand[(a + c) * T];
            cand[(a + c) * T] = cand[(b + c) * T];
            cand[(b + c) * T] = x;
          }
        }
      }
    }
    // keep the candidate when it is lexicographically smaller
    // (signed int32, the first differing lane decides)
    int o = 0;
    while (o < w && cand[o * T] == best[o * T]) ++o;
    if (o < w && cand[o * T] < best[o * T]) {
      for (; o < w; ++o) best[o * T] = cand[o * T];
    }
  }
  for (int o = 0; o < w; ++o) in[o] = best[o * T];
}

// words before p's first 16-byte boundary, at most nw
__device__ inline int head4(const int32_t* p, int nw) {
  const int h = static_cast<int>(
      ((16u - (static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p)) &
               15u)) & 15u) >> 2);
  return h < nw ? h : nw;
}

// s[(i / w) * ws + i % w] = g[i] for i in [0, nw)
__device__ void tile_in(const int32_t* __restrict__ g, int nw, int w,
                        int ws, int32_t* __restrict__ s) {
  const int h = head4(g, nw), nv = (nw - h) >> 2;
  for (int i = threadIdx.x; i < h; i += blockDim.x)
    s[(i / w) * ws + i % w] = g[i];
  const int4* gv = reinterpret_cast<const int4*>(g + h);
  for (int v = threadIdx.x; v < nv; v += blockDim.x) {
    const int4 q = __ldg(gv + v);
    const int32_t e[4] = {q.x, q.y, q.z, q.w};
    const int i = h + 4 * v;
    int r = i / w, l = i - r * w;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      s[r * ws + l] = e[k];
      if (++l == w) {
        l = 0;
        ++r;
      }
    }
  }
  for (int i = h + 4 * nv + threadIdx.x; i < nw; i += blockDim.x)
    s[(i / w) * ws + i % w] = g[i];
}

// g[i] = s[(i / w) * ws + i % w] for i in [0, nw)
__device__ void tile_out(const int32_t* __restrict__ s, int nw, int w,
                         int ws, int32_t* __restrict__ g) {
  const int h = head4(g, nw), nv = (nw - h) >> 2;
  for (int i = threadIdx.x; i < h; i += blockDim.x)
    g[i] = s[(i / w) * ws + i % w];
  int4* gv = reinterpret_cast<int4*>(g + h);
  for (int v = threadIdx.x; v < nv; v += blockDim.x) {
    const int i = h + 4 * v;
    int r = i / w, l = i - r * w;
    int32_t e[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      e[k] = s[r * ws + l];
      if (++l == w) {
        l = 0;
        ++r;
      }
    }
    gv[v] = make_int4(e[0], e[1], e[2], e[3]);
  }
  for (int i = h + 4 * nv + threadIdx.x; i < nw; i += blockDim.x)
    g[i] = s[(i / w) * ws + i % w];
}

__global__ void __launch_bounds__(kMaxThreads)
    canon_kernel(const int32_t* __restrict__ rows,
                 const bool* __restrict__ valid,
                 const int32_t* __restrict__ gprog, int prog_len,
                 int staged, int32_t* __restrict__ out, int64_t n, int w) {
  extern __shared__ int4 smem4[];
  int32_t* smem = reinterpret_cast<int32_t*>(smem4);
  const int T = blockDim.x;
  const int ws = w | 1;
  const int32_t* base = gprog;
  int32_t* cnt = smem;
  if (staged) {
    for (int i = threadIdx.x; i < prog_len; i += T) smem[i] = gprog[i];
    base = smem;
    cnt = smem + ((prog_len + 3) & ~3);
  }
  __syncthreads();
  const Prog pg = read_prog(base);
  const int nl = (base[5] - base[4]) / 3;
  uint32_t* fast = reinterpret_cast<uint32_t*>(cnt + 4);
  int32_t* idx = cnt + 4 + ((nl + 3) & ~3);
  int32_t* tile = idx + T;
  int32_t* best = tile + T * ws;
  // the candidate is built whole only where sort blocks apply
  int32_t* cand = pg.ps[pg.P] > 0 ? best + w * T : nullptr;
  for (int l = threadIdx.x; l < nl; l += T) fast[l] = pack_lane_op(pg, l);
  const int t = threadIdx.x;
  for (int64_t r0 = static_cast<int64_t>(blockIdx.x) * T; r0 < n;
       r0 += static_cast<int64_t>(gridDim.x) * T) {
    const int nt = static_cast<int>(n - r0 < T ? n - r0 : T);
    tile_in(rows + r0 * w, nt * w, w, ws, tile);
    if (t == 0) *cnt = 0;
    __syncthreads();
    if (t < nt && valid[r0 + t]) idx[atomicAdd(cnt, 1)] = t;
    __syncthreads();
    if (t < *cnt)
      canon_row(pg, fast, tile + idx[t] * ws, cand + t, best + t, T, w);
    __syncthreads();
    tile_out(tile, nt * w, w, ws, out + r0 * w);
    __syncthreads();
  }
}

}  // namespace

// K5 over n rows of w lanes: `threads` rows a tile, the program staged
// in shared memory when `staged`, `smem` bytes of shared memory a block
// (kernels/ops.py canon_geometry computes the three)
extern "C" cudaError_t jmc_canon_rows(const int32_t* rows, const bool* valid,
                                      const int32_t* prog, int prog_len,
                                      int staged, int threads, int smem,
                                      int32_t* out, int64_t n, int w,
                                      cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  if (threads < 1 || threads > kMaxThreads || w < 1 || w > 32767)
    return cudaErrorInvalidValue;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(canon_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, canon_kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > static_cast<int64_t>(per_sm) * sms)
    blocks = static_cast<int64_t>(per_sm) * sms;
  canon_kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      rows, valid, prog, prog_len, staged, out, n, w);
  return cudaGetLastError();
}
