// K1 unpack_rows: bit-packed state rows -> unpacked int32 lanes.
//
// Replaces: jaxmc/compile/pack.py:421 LanePlan.unpack_rows (the word
// gather, shift and mask, bias, sign restore and SENTINEL mapping that
// XLA fused at the top of every level step, jaxmc/backend/bfs.py:1768).
//
// Bound on the card: bytes.  Each output lane costs one 4-byte load of
// its packed word (N*PW*4 bytes read when the words are reused from
// cache) and one 4-byte store (N*W*4 bytes written), against a handful
// of integer operations.
//
// Design: one thread per (row, lane), so consecutive threads store
// consecutive lanes of a row (coalesced stores) and the few words of a
// row are read by neighbouring threads from L1/L2.  The plan's per-lane
// arrays are small and stay cached.  Indices are 64-bit: N*W reaches
// hundreds of millions at real sizes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kSentinel = 0x7FFFFFFF;

__global__ void unpack_rows_kernel(const int32_t* __restrict__ packed,
                                   const int32_t* __restrict__ word,
                                   const int32_t* __restrict__ shift,
                                   const int32_t* __restrict__ mask,
                                   const int32_t* __restrict__ bias,
                                   const int32_t* __restrict__ full,
                                   const int32_t* __restrict__ sent_code,
                                   int32_t* __restrict__ out,
                                   int64_t n, int pw, int w) {
  const int64_t total = n * static_cast<int64_t>(w);
  for (int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       t < total; t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = t / w;
    const int lane = static_cast<int>(t - r * w);
    const uint32_t pu =
        static_cast<uint32_t>(packed[r * pw + word[lane]]);
    const uint32_t raw = (pu >> static_cast<uint32_t>(shift[lane])) &
                         static_cast<uint32_t>(mask[lane]);
    // raw < 2^31 on packed lanes; on full lanes the cast restores the
    // sign bit (lax.bitcast_convert_type in the reference)
    const int32_t v = static_cast<int32_t>(raw);
    int32_t o = full[lane]
                    ? v
                    : static_cast<int32_t>(static_cast<uint32_t>(v) +
                                           static_cast<uint32_t>(bias[lane]));
    const int32_t sc = sent_code[lane];
    if (sc >= 0 && v == sc) o = kSentinel;
    out[t] = o;
  }
}

}  // namespace

extern "C" cudaError_t jmc_unpack_rows(const int32_t* packed,
                                       const int32_t* word,
                                       const int32_t* shift,
                                       const int32_t* mask,
                                       const int32_t* bias,
                                       const int32_t* full,
                                       const int32_t* sent_code,
                                       int32_t* out, int64_t n, int pw,
                                       int w, cudaStream_t stream) {
  const int64_t total = n * static_cast<int64_t>(w);
  if (total <= 0) return cudaSuccess;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  unpack_rows_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      packed, word, shift, mask, bias, full, sent_code, out, n, pw, w);
  return cudaGetLastError();
}
