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
// Design: one thread per row.  The plan assigns lanes to words in
// increasing order (pack.py's greedy placement), so a thread walks its
// row's lanes once, ORs each field into a register word and hands the
// word on when the lane's word index moves on: each packed word is
// written exactly once and nothing is read back.  Key words stream into
// KeyAcc, which stores them (exact) or mixes them into four registers
// (fp128), so a separate basis costs one more walk and no storage.  The
// pack-overflow flag is OR-reduced with one atomic per offending valid
// row, which never happens on a healthy run; a caller that wants the
// per-row flags of the stored rows (LanePlan.pack_rows) passes a
// row_ovf buffer, the level step passes null.  Row reads are strided by
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

// key basis: the stored packed row, another row block packed with the
// same plan (the SYMMETRY canonical rows), or raw lanes (the VIEW)
enum Basis { kStored = 0, kPackOther = 1, kRaw = 2 };

struct Plan {
  const int32_t *word, *shift, *mask, *bias, *allowed, *full, *sent_code;
};

// Pack one row with the plan, handing each finished word to emit(p, word)
// in increasing p; returns the range-guard verdict (a guarded lane
// outside its profiled range).
template <class Emit>
__device__ inline bool pack_row(const int32_t* row, int w, int pw,
                                const Plan& pl, Emit emit) {
  bool bad = false;
  int cur = 0;
  uint32_t acc = 0;
  for (int i = 0; i < w; ++i) {
    const int32_t v = row[i];
    const int sc = pl.sent_code[i];
    uint32_t code_u;
    if (pl.full[i]) {
      code_u = static_cast<uint32_t>(v);
    } else {
      const int32_t code =
          (sc >= 0 && v == kSentinel)
              ? sc
              : static_cast<int32_t>(static_cast<uint32_t>(v) -
                                     static_cast<uint32_t>(pl.bias[i]));
      bad |= (code < 0) || (code > pl.allowed[i]);
      code_u = static_cast<uint32_t>(code);
    }
    const int wd = pl.word[i];
    while (cur < wd) {  // lanes fill words in increasing order
      emit(cur, acc);
      acc = 0;
      ++cur;
    }
    acc |= (code_u & static_cast<uint32_t>(pl.mask[i]))
           << static_cast<uint32_t>(pl.shift[i]);
  }
  while (cur < pw) {
    emit(cur, acc);
    acc = 0;
    ++cur;
  }
  return bad;
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

template <bool FP, int BASIS>
__global__ void keys_of_kernel(const int32_t* __restrict__ rows,
                               const bool* __restrict__ valid, Plan pl,
                               const int32_t* __restrict__ basis, int bw,
                               int32_t* __restrict__ keys,
                               int32_t* __restrict__ packed,
                               int32_t* __restrict__ ovf_flag,
                               bool* __restrict__ row_ovf, int64_t n,
                               int w, int pw) {
  const int k = (FP ? 4 : (BASIS == kRaw ? bw : pw)) + 1;
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
    KeyAcc<FP> key(krow);
    bool bad;
    bool bad_key = false;
    if (BASIS == kStored) {
      bad = pack_row(rows + r * w, w, pw, pl, [&](int p, uint32_t x) {
        prow[p] = static_cast<int32_t>(x);
        key.put(x);
      });
    } else {
      bad = pack_row(rows + r * w, w, pw, pl, [&](int p, uint32_t x) {
        prow[p] = static_cast<int32_t>(x);
      });
      if (BASIS == kPackOther) {
        bad_key = pack_row(basis + r * w, w, pw, pl,
                           [&](int, uint32_t x) { key.put(x); });
      } else {
        const int32_t* b = basis + r * bw;
        for (int j = 0; j < bw; ++j) key.put(static_cast<uint32_t>(b[j]));
      }
    }
    key.finish();
    if (bad || bad_key) atomicOr(ovf_flag, 1);
    if (row_ovf) row_ovf[r] = bad;
  }
}

template <bool FP, int BASIS>
void launch(unsigned blocks, int threads, cudaStream_t stream,
            const int32_t* rows, const bool* valid, const Plan& pl,
            const int32_t* basis, int bw, int32_t* keys, int32_t* packed,
            int32_t* ovf_flag, bool* row_ovf, int64_t n, int w, int pw) {
  keys_of_kernel<FP, BASIS><<<blocks, threads, 0, stream>>>(
      rows, valid, pl, basis, bw, keys, packed, ovf_flag, row_ovf, n, w, pw);
}

}  // namespace

extern "C" cudaError_t jmc_keys_of(
    const int32_t* rows, const bool* valid, const int32_t* word,
    const int32_t* shift, const int32_t* mask, const int32_t* bias,
    const int32_t* allowed, const int32_t* full, const int32_t* sent_code,
    const int32_t* basis, int32_t* keys, int32_t* packed, int32_t* ovf_flag,
    bool* row_ovf, int64_t n, int w, int pw, int fp_mode, int basis_kind,
    int bw, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(ovf_flag, 0, sizeof(int32_t), stream);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaGetLastError();
  if (basis_kind < kStored || basis_kind > kRaw) return cudaErrorInvalidValue;
  const Plan pl{word, shift, mask, bias, allowed, full, sent_code};
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  const unsigned b = static_cast<unsigned>(blocks);
#define JMC_KEYS(FP, BASIS)                                                \
  launch<FP, BASIS>(b, threads, stream, rows, valid, pl, basis, bw, keys, \
                    packed, ovf_flag, row_ovf, n, w, pw)
  if (fp_mode) {
    if (basis_kind == kStored) JMC_KEYS(true, kStored);
    else if (basis_kind == kPackOther) JMC_KEYS(true, kPackOther);
    else JMC_KEYS(true, kRaw);
  } else {
    if (basis_kind == kStored) JMC_KEYS(false, kStored);
    else if (basis_kind == kPackOther) JMC_KEYS(false, kPackOther);
    else JMC_KEYS(false, kRaw);
  }
#undef JMC_KEYS
  return cudaGetLastError();
}
