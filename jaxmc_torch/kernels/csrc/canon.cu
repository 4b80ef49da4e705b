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
// lanes, signed order), inner ones first.  One kernel serves every
// layout: nothing is generated per permutation.
//
// Bound on the card: bytes for few permutations, operations for many.
// Compulsory traffic is one read of every row (N*W*4), one byte of
// validity each and one write of every row (N*W*4); the operations are
// about P*W*(alternatives + compare) integer steps per valid row.
//
// Design: one thread per row, grid-stride.  The program (a few KB) is
// staged in shared memory by every block when it fits, else read from
// device memory (uniform addresses across the warp: broadcasts).  The
// candidate and the running minimum live in a per-thread scratch in
// device memory, lane-major with the thread index minor (the wrapper
// allocates 2*W words per launched thread), so the lanes of neighbouring
// threads are neighbouring words; the input row is read row-major and
// hits L1 after its first lane.  The in-row sorts are insertion sorts
// over at most cap rows.  Indices are 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kSentinel = 0x7FFFFFFF;
constexpr int kHeader = 16;
constexpr int kThreads = 256;

struct Prog {
  const int32_t* base;
  int P, U, W;
  const int32_t *pl, *lops, *alts, *conds, *ps, *sorts, *tabs;
};

__device__ inline Prog read_prog(const int32_t* b) {
  Prog p;
  p.base = b;
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

__global__ void canon_kernel(const int32_t* __restrict__ rows,
                             const bool* __restrict__ valid,
                             const int32_t* __restrict__ gprog,
                             int prog_len, int use_smem,
                             int32_t* __restrict__ out,
                             int32_t* __restrict__ scratch, int64_t n,
                             int w) {
  extern __shared__ int32_t smem[];
  const int32_t* base = gprog;
  if (use_smem) {
    for (int i = threadIdx.x; i < prog_len; i += blockDim.x)
      smem[i] = gprog[i];
    __syncthreads();
    base = smem;
  }
  const Prog pg = read_prog(base);
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  // lane o of this thread's candidate / minimum
  int32_t* cand = scratch + t;
  int32_t* best = scratch + static_cast<int64_t>(w) * nthreads + t;
  for (int64_t r = t; r < n; r += nthreads) {
    const int32_t* in = rows + r * w;
    int32_t* orow = out + r * w;
    if (!valid[r]) {
      for (int o = 0; o < w; ++o) orow[o] = in[o];
      continue;
    }
    for (int o = 0; o < w; ++o) best[o * nthreads] = in[o];
    for (int p = 0; p < pg.P; ++p) {
      for (int o = 0; o < w; ++o) cand[o * nthreads] = in[o];
      const int32_t* tab = pg.tabs + static_cast<int64_t>(p) * pg.U;
      for (int l = pg.pl[p]; l < pg.pl[p + 1]; ++l) {
        const int o = pg.lops[3 * l];
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
          cand[o * nthreads] = v;
          break;
        }
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
              const int32_t x = cand[(a + c) * nthreads];
              const int32_t y = cand[(b + c) * nthreads];
              cmp = (x < y) ? -1 : (x > y ? 1 : 0);
            }
            if (cmp >= 0) break;
            for (int c = 0; c < rw; ++c) {
              const int32_t x = cand[(a + c) * nthreads];
              cand[(a + c) * nthreads] = cand[(b + c) * nthreads];
              cand[(b + c) * nthreads] = x;
            }
          }
        }
      }
      // keep the candidate when it is lexicographically smaller
      // (signed int32, the first differing lane decides)
      int o = 0;
      while (o < w && cand[o * nthreads] == best[o * nthreads]) ++o;
      if (o < w && cand[o * nthreads] < best[o * nthreads]) {
        for (; o < w; ++o) best[o * nthreads] = cand[o * nthreads];
      }
    }
    for (int o = 0; o < w; ++o) orow[o] = best[o * nthreads];
  }
}

}  // namespace

// Threads the launch uses for n rows: the scratch the caller allocates
// is 2 * w * jmc_canon_threads(n) int32 words.
extern "C" int64_t jmc_canon_threads(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  return blocks * kThreads;
}

extern "C" cudaError_t jmc_canon_rows(const int32_t* rows, const bool* valid,
                                      const int32_t* prog, int prog_len,
                                      int32_t* out, int32_t* scratch,
                                      int64_t n, int w,
                                      cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  const int64_t blocks = jmc_canon_threads(n) / kThreads;
  const size_t bytes = static_cast<size_t>(prog_len) * sizeof(int32_t);
  // the program goes to shared memory when it fits a block's share
  const int use_smem = bytes <= 200 * 1024;
  if (use_smem && bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        canon_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  canon_kernel<<<static_cast<unsigned>(blocks), kThreads,
                 use_smem ? bytes : 0, stream>>>(rows, valid, prog, prog_len,
                                                 use_smem, out, scratch, n, w);
  return cudaGetLastError();
}
