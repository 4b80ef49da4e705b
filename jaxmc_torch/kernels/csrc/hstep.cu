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
// [A*CH, PW] packed rows, K2's pack-overflow flag (a device bool), and
// the predicate bits inv_ok and explore [A*CH] bool.
// Outputs: scalars int64[6] = (nv, overflow code, assert_any, first
// assert flat index a*CH+f, dead_any, first dead f); dead [CH] bool; the
// first nv entries of idx [C] int32, fps [C, 4], rows [C, PW] and
// inv_ok / explore [C] bool, in candidate order a*CH + f.
//
// Bound on the card: bytes.  en, aok and ov are read once (6 bytes a
// candidate); only the nv valid candidates' four fingerprint words, PW
// row words and predicate bits are read, and the same written compacted
// with their index; dead is written once.  At a chunk's sizes (a bound
// of 0.0059 ms at the 4-process model's busiest chunk) the launch and the
// wrapper's host work set the time, not the bytes (PERF.md §6, B.9).
//
// Design: one launch, K8's single-pass stable compaction with decoupled
// look-back (lookback.cuh).  The grid covers max(C, CH) indices in tiles
// of T = 4,096 (256 threads x 16: one 16-byte load of en and of aok and
// 64 bytes of ov a thread, as K8; shared memory 16 KB of staged
// indices).  A tile takes a ticket, counts its valid candidates (en and
// f < fcount), ranks them by a block scan and stages their indices in
// shared memory; its first warp publishes the count, looks back over the
// earlier tiles a warp's width at a time and publishes the inclusive
// prefix.  The block then writes its valid candidates' index, four
// fingerprint words, PW row words and two predicate bits at their ranks,
// each output as one contiguous run.  dead[f] is written for the tile's
// share of the CH slots (spread evenly over the tiles) by warps 1-7
// while warp 0 looks back: A independent byte loads a slot.  The maximum
// overflow code, the first assert-bad index and the first dead slot are
// order-free atomicMax on three words of the workspace (the "first"
// indices as kNone - i).  The tile with the last ticket writes nv; the
// block that finishes last (a done-count after a __threadfence) writes
// the other five scalars, with OV_PACK when the base code is 0 and K2's
// flag is set, and sets the reductions and the done-count back to 0, as
// the take of the last ticket sets the ticket back.
// Scratch: a workspace the wrapper caches for each device and stream
// (status words, ticket, done-count, reductions); the status words carry
// the call's epoch, so nothing is cleared between calls, and calls on
// one stream run one after another (the wrapper enqueues each under a
// lock and refuses CUDA graph capture, which would replay one epoch).
// Every output element is written by one thread, the look-back's sums do
// not depend on timing and the only atomics are max, so the result is
// the same on every run.  Candidate indices fit in int32 (the wrapper
// refuses A*CH >= 2^31 - 256).

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

using jmc_lb::Entries;
using jmc_lb::kNone;
using jmc_lb::kTile;
using jmc_lb::kTileThreads;
using jmc_lb::kTileWarps;

__global__ void __launch_bounds__(kTileThreads) hstep_kernel(
    const bool* __restrict__ en, const bool* __restrict__ aok,
    const int32_t* __restrict__ ov, const int32_t* __restrict__ keys,
    const int32_t* __restrict__ cand, const bool* __restrict__ inv_ok,
    const bool* __restrict__ explore, const bool* __restrict__ pack_ovf,
    int64_t* __restrict__ scalars, bool* __restrict__ dead,
    int32_t* __restrict__ idx, int32_t* __restrict__ fps,
    int32_t* __restrict__ rows, bool* __restrict__ inv_out,
    bool* __restrict__ exp_out, uint64_t* __restrict__ status,
    uint32_t* __restrict__ ticket, uint32_t* __restrict__ done,
    int32_t* __restrict__ red, int a_n, int32_t ch, int32_t fcount, int pw,
    int32_t ov_pack, int ntiles, int32_t spt, uint32_t epoch) {
  __shared__ int32_t s_idx[kTile];
  __shared__ int s_warp[kTileWarps];
  __shared__ int32_t s_red[2][kTileWarps];
  __shared__ int s_tile;
  __shared__ uint32_t s_excl;
  __shared__ bool s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = jmc_lb::take_ticket(ticket, ntiles, &s_tile);
  const int64_t c = static_cast<int64_t>(a_n) * ch;
  const Entries e = jmc_lb::tile_entries(en, tile, c, ch, fcount);
  int32_t r_ov = 0, r_ab = 0;
  jmc_lb::verdict_partials(e, aok, ov, &r_ov, &r_ab);
  int nset;
  const int rank = jmc_lb::block_scan(__popc(e.set), s_warp, &nset);
  jmc_lb::stage(s_idx, rank, e.set, e.i0);
  r_ov = jmc_lb::warp_max(r_ov);
  r_ab = jmc_lb::warp_max(r_ab);
  if (lane == 0) {
    s_red[0][warp] = r_ov;
    s_red[1][warp] = r_ab;
  }
  __syncthreads();
  int32_t r_dead = 0;
  if (warp == 0) {
    if (lane < 2) {
      int32_t m = 0;
      for (int w = 0; w < kTileWarps; ++w) m = max(m, s_red[lane][w]);
      if (m > 0) atomicMax(red + lane, m);
    }
    const uint32_t excl = jmc_lb::look_back(status, tile, epoch,
                                            static_cast<uint32_t>(nset));
    if (lane == 0) {
      s_excl = excl;
      if (tile == ntiles - 1) scalars[0] = static_cast<int64_t>(excl) + nset;
    }
  } else {
    // while warp 0 looks back, the other warps take this tile's share of
    // the dead slots, [tile * spt, (tile + 1) * spt) of [0, CH): the A
    // loads of a slot are independent; f rises in a thread, so its first
    // dead slot is its least
    const int64_t f_lo = static_cast<int64_t>(tile) * spt;
    const int64_t f_hi = f_lo + spt < ch ? f_lo + spt : ch;
    for (int64_t f = f_lo + tid - 32; f < f_hi; f += kTileThreads - 32) {
      bool any = false;
      for (int a = 0; a < a_n; ++a)
        any = any | en[static_cast<int64_t>(a) * ch + f];
      const bool d = f < fcount && !any;
      dead[f] = d;
      if (d && r_dead == 0) r_dead = kNone - static_cast<int32_t>(f);
    }
  }
  r_dead = jmc_lb::warp_max(r_dead);
  if (lane == 0 && r_dead > 0) atomicMax(red + 2, r_dead);
  __syncthreads();
  // the valid candidates at their ranks, each output one contiguous run
  const int64_t ex = s_excl;
  for (int j = tid; j < nset; j += kTileThreads) {
    const int32_t src = s_idx[j];
    idx[ex + j] = src;
    inv_out[ex + j] = inv_ok[src];
    exp_out[ex + j] = explore[src];
  }
  for (int w = tid; w < nset * 4; w += kTileThreads)
    fps[ex * 4 + w] = keys[static_cast<int64_t>(s_idx[w >> 2]) * 5 + 1 +
                           (w & 3)];
  for (int w = tid; w < nset * pw; w += kTileThreads) {
    const int j = w / pw;
    rows[ex * pw + w] = cand[static_cast<int64_t>(s_idx[j]) * pw + w - j * pw];
  }
  // the block that finishes last writes the reductions and resets them
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(done, 1u) == static_cast<uint32_t>(ntiles - 1);
  __syncthreads();
  if (s_last && tid == 0) {
    __threadfence();
    const int32_t m = atomicExch(red, 0), b = atomicExch(red + 1, 0),
                  d = atomicExch(red + 2, 0);
    atomicExch(done, 0u);
    // kernel overflow codes outrank the pack guard
    scalars[1] = m != 0 ? m : (*pack_ovf ? ov_pack : 0);
    scalars[2] = b != 0;
    scalars[3] = b != 0 ? kNone - b : 0;
    scalars[4] = d != 0;
    scalars[5] = d != 0 ? kNone - d : 0;
  }
}

}  // namespace

extern "C" int jmc_hstep_tile() { return kTile; }

// K7's workspace for `tiles` tiles: status words [tiles] uint64, the
// ticket, the done-count, the three reductions; zeros when made
extern "C" int64_t jmc_hstep_workspace_bytes(int tiles) {
  return static_cast<int64_t>(tiles) * 8 + 24;
}

extern "C" cudaError_t jmc_hstep_epilogue(
    const bool* en, const bool* aok, const int32_t* ov, const int32_t* keys,
    const int32_t* cand, const bool* inv_ok, const bool* explore,
    const bool* pack_ovf, int64_t* scalars, bool* dead, int32_t* idx,
    int32_t* fps, int32_t* rows, bool* inv_out, bool* exp_out, void* ws,
    int a_n, int32_t ch, int32_t fcount, int pw, int32_t ov_pack, int ntiles,
    int ws_tiles, int epoch, cudaStream_t stream) {
  uint64_t* status = static_cast<uint64_t*>(ws);
  uint32_t* ticket = reinterpret_cast<uint32_t*>(status + ws_tiles);
  uint32_t* done = ticket + 1;
  int32_t* red = reinterpret_cast<int32_t*>(ticket + 2);
  const int32_t spt = ch > 0 ? (ch + ntiles - 1) / ntiles : 0;
  hstep_kernel<<<ntiles, kTileThreads, 0, stream>>>(
      en, aok, ov, keys, cand, inv_ok, explore, pack_ovf, scalars, dead, idx,
      fps, rows, inv_out, exp_out, status, ticket, done, red, a_n, ch, fcount,
      pw, ov_pack, ntiles, spt, static_cast<uint32_t>(epoch));
  return cudaGetLastError();
}
