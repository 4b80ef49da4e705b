// K2 keys_of: unpacked candidate rows -> dedup keys + packed rows.
//
// Replaces: jaxmc/compile/pack.py:441 LanePlan.pack_rows inside
// jaxmc/backend/bfs.py:1584 TpuExplorer._keys_of (bias, range guard,
// sentinel code, shift into word, OR of disjoint fields; SENTINEL fill
// of invalid rows; validity lane first), fused with
// jaxmc/backend/bfs.py:126 fingerprint128 when the engine keys on
// 128-bit fingerprints (fp_mode).
//
// Bound on the card: bytes.  Every validity byte is read (N bytes),
// the lanes of the valid rows only (valid*W*4; an invalid row is never
// read), and every row's key and packed words are written once
// (N*(PW+K)*4 bytes); the work per lane is a few integer operations,
// and the fingerprint adds 8 multiplies per packed word.
//
// Design: one thread per row.  The plan assigns lanes to words in
// increasing order (pack.py's greedy placement), so a thread walks its
// row's lanes once, ORs each field into a register word and stores the
// word when the lane's word index moves on: each packed word is written
// exactly once and nothing is read back.  The fingerprint is a template
// branch that re-reads the row's PW words just stored (L1 hits).  The
// pack-overflow flag is OR-reduced with one atomic per offending valid
// row, which never happens on a healthy run; a caller that wants the
// per-row flags (LanePlan.pack_rows) passes a row_ovf buffer, the level
// step passes null.  Row reads are strided by
// W lanes between threads; a later PR can stage rows through shared
// memory.  Indices are 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kSentinel = 0x7FFFFFFF;

__constant__ uint32_t kMix1[4] = {0x9E3779B1u, 0xC2B2AE35u, 0x165667B1u,
                                  0x85EBCA6Bu};
__constant__ uint32_t kMix2[4] = {0x85EBCA6Bu, 0x27D4EB2Fu, 0x9E3779B1u,
                                  0xC2B2AE35u};

template <bool FP>
__global__ void keys_of_kernel(const int32_t* __restrict__ rows,
                               const bool* __restrict__ valid,
                               const int32_t* __restrict__ word,
                               const int32_t* __restrict__ shift,
                               const int32_t* __restrict__ mask,
                               const int32_t* __restrict__ bias,
                               const int32_t* __restrict__ allowed,
                               const int32_t* __restrict__ full,
                               const int32_t* __restrict__ sent_code,
                               int32_t* __restrict__ keys,
                               int32_t* __restrict__ packed,
                               int32_t* __restrict__ ovf_flag,
                               bool* __restrict__ row_ovf, int64_t n,
                               int w, int pw) {
  const int k = (FP ? 4 : pw) + 1;
  for (int64_t r = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       r < n; r += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    int32_t* krow = keys + r * k;
    int32_t* prow = packed + r * pw;
    if (!valid[r]) {
      krow[0] = 1;
      for (int j = 1; j < k; ++j) krow[j] = kSentinel;
      for (int p = 0; p < pw; ++p) prow[p] = kSentinel;
      if (row_ovf) row_ovf[r] = false;
      continue;
    }
    const int32_t* row = rows + r * w;
    bool bad = false;
    int cur = 0;
    uint32_t acc = 0;
    for (int i = 0; i < w; ++i) {
      const int32_t v = row[i];
      const int sc = sent_code[i];
      uint32_t code_u;
      if (full[i]) {
        code_u = static_cast<uint32_t>(v);
      } else {
        const int32_t code =
            (sc >= 0 && v == kSentinel)
                ? sc
                : static_cast<int32_t>(static_cast<uint32_t>(v) -
                                       static_cast<uint32_t>(bias[i]));
        bad |= (code < 0) || (code > allowed[i]);
        code_u = static_cast<uint32_t>(code);
      }
      const int wd = word[i];
      while (cur < wd) {  // lanes fill words in increasing order
        prow[cur] = static_cast<int32_t>(acc);
        acc = 0;
        ++cur;
      }
      acc |= (code_u & static_cast<uint32_t>(mask[i]))
             << static_cast<uint32_t>(shift[i]);
    }
    while (cur < pw) {
      prow[cur] = static_cast<int32_t>(acc);
      acc = 0;
      ++cur;
    }
    if (bad) atomicOr(ovf_flag, 1);
    if (row_ovf) row_ovf[r] = bad;
    krow[0] = 0;
    if (FP) {
      for (int j = 0; j < 4; ++j) {
        uint32_t h = 2166136261u + static_cast<uint32_t>(j) * 0x9E3779B1u;
        for (int p = 0; p < pw; ++p) {
          h = (h ^ (static_cast<uint32_t>(prow[p]) * kMix1[j])) * kMix2[j];
        }
        h ^= h >> 15;
        h *= 0x2C1B3C6Du;
        h ^= h >> 12;
        krow[1 + j] = static_cast<int32_t>(h);
      }
    } else {
      for (int p = 0; p < pw; ++p) krow[1 + p] = prow[p];
    }
  }
}

}  // namespace

extern "C" cudaError_t jmc_keys_of(const int32_t* rows, const bool* valid,
                                   const int32_t* word, const int32_t* shift,
                                   const int32_t* mask, const int32_t* bias,
                                   const int32_t* allowed,
                                   const int32_t* full,
                                   const int32_t* sent_code, int32_t* keys,
                                   int32_t* packed, int32_t* ovf_flag,
                                   bool* row_ovf, int64_t n, int w, int pw,
                                   int fp_mode, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(ovf_flag, 0, sizeof(int32_t), stream);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaGetLastError();
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  if (fp_mode) {
    keys_of_kernel<true><<<static_cast<unsigned>(blocks), threads, 0,
                           stream>>>(rows, valid, word, shift, mask, bias,
                                     allowed, full, sent_code, keys, packed,
                                     ovf_flag, row_ovf, n, w, pw);
  } else {
    keys_of_kernel<false><<<static_cast<unsigned>(blocks), threads, 0,
                            stream>>>(rows, valid, word, shift, mask, bias,
                                      allowed, full, sent_code, keys, packed,
                                      ovf_flag, row_ovf, n, w, pw);
  }
  return cudaGetLastError();
}
