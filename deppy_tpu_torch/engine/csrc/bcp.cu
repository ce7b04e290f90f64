// Kernel 1: batched BCP to a fixpoint.
//
// Replaces deppy_tpu/engine/pallas_bcp.py:_kernel (:50; entry bcp_fixpoint
// :79, pallas_call :92): loop the propagation round until nothing changes
// or a conflict appears.  No entry-overlap check, as in the Pallas kernel;
// the caller folds that in (core.planes_fixpoint).
//
// Two teams compute the same function; teams.team picks one per launch
// from the impl and the shape (cuda_bcp.bcp_fixpoint):
//
// * the warp team (bcp_warp_kernel), every launch of the bits path: one
//   warp owns one problem and several problems share a block.  The warp
//   stages the problem's planes, bounds and activity once into its slice
//   of shared memory (warp_stage) and runs warp.cuh's warp_fixpoint with
//   one assignment word a lane in registers, no block barrier and no
//   shared write inside a round;
// * the block team (bcp_kernel), shapes the rule refuses (planes past 32
//   words, or a slice past the per-problem budget): one thread block per
//   problem, the assignment and accumulators in shared memory and the
//   planes re-read from L2 every round (fixpoint.cuh); and every launch
//   under the watched and gather impls, whose arms (watched.cuh, selected
//   by an ArmArgs) read the raw rows, the clause bank and compact rows
//   instead of the planes.
//
// Bound on the H100: the bytes it must move once are the planes, the two
// assignment planes and the extras row.  Rounds are a chain (each depends
// on the last), so a problem's latency is rounds x (row scan + the round's
// synchronisation), and a launch of few problems is latency-bound: the
// warp team cuts the synchronisation to warp shuffles and votes and keeps
// the staged planes in shared memory.
#include <cuda_runtime.h>

#include "warp.cuh"

namespace {

using namespace deppy;

__global__ void bcp_kernel(const uint32_t* __restrict__ pos,
                           const uint32_t* __restrict__ neg,
                           const uint32_t* __restrict__ mem,
                           const int* __restrict__ act,
                           const int* __restrict__ card_n,
                           const uint32_t* __restrict__ min_bits,
                           const int* __restrict__ min_w,
                           const uint32_t* __restrict__ t0,
                           const uint32_t* __restrict__ f0,
                           const int* __restrict__ en, int* conflict,
                           uint32_t* t_out, uint32_t* f_out, int C, int NA,
                           int W, ArmArgs A) {
  extern __shared__ uint32_t smem[];
  const int b = blockIdx.x;
  const Work S = carve_work(smem, W, NA);
  Planes P{};
  if (pos != nullptr) {
    P.pos = pos + (size_t)b * C * W;
    P.neg = neg + (size_t)b * C * W;
    P.mem = mem + (size_t)b * NA * W;
  }
  P.card_n = card_n + (size_t)b * NA;
  P.card_valid = act + (size_t)b * NA;
  P.card_act = nullptr;
  P.C = C;
  P.NA = NA;
  P.W = W;
  P.tile_rows = 0;
  set_arm(P, A, smem, b);
  block_copy(S.t, t0 + (size_t)b * W, W);
  block_copy(S.f, f0 + (size_t)b * W, W);
  const bool c = fixpoint(P, S, min_bits + (size_t)b * W, min_w[b],
                          en[b] != 0, false);
  if (threadIdx.x == 0) conflict[b] = c ? 1 : 0;
  block_copy(t_out + (size_t)b * W, S.t, W);
  block_copy(f_out + (size_t)b * W, S.f, W);
}

// The warp team: warp b % warps of block b / warps owns problem b, with
// ``slice_words`` of shared memory (warp_work_words).  Kernel 1's row
// activity is its ``act`` argument, staged in warp_stage's card_valid
// slot: a row is active where act != 0.  Lane w holds words w of t, f and
// min_bits; lanes >= W hold zeros.  The extras row is always present: a
// zero row with min_w 0 forces nothing and adds no conflict.  A disabled
// problem runs zero rounds; its planes are staged all the same, so that
// every load of the problem goes out before ``en`` comes back.  WMAX:
// warp_words_bound(W).
template <int WMAX>
__global__ void __launch_bounds__(32 * kMaxWarps) bcp_warp_kernel(
    const uint32_t* __restrict__ pos, const uint32_t* __restrict__ neg,
    const uint32_t* __restrict__ mem, const int* __restrict__ act,
    const int* __restrict__ card_n, const uint32_t* __restrict__ min_bits,
    const int* __restrict__ min_w, const uint32_t* __restrict__ t0,
    const uint32_t* __restrict__ f0, const int* __restrict__ en,
    int* conflict, uint32_t* t_out, uint32_t* f_out, int B, int C, int NA,
    int W, size_t slice_words) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp: no block barrier follows
  const bool own = lane < W;
  const size_t row = (size_t)b * W + lane;
  const bool run = en[b] != 0;
  const int mw = min_w[b];
  const uint32_t mb = own ? min_bits[row] : 0u;
  uint32_t t = own ? t0[row] : 0u;
  uint32_t f = own ? f0[row] : 0u;
  const WarpPlanes P =
      warp_stage(smem + (size_t)warp * slice_words, pos, neg, mem, card_n,
                 act, nullptr, C, NA, W, b, lane);
  const bool c = warp_fixpoint<WMAX, true>(P, t, f, mb, mw, run, false, lane);
  if (lane == 0) conflict[b] = c ? 1 : 0;
  if (own) {
    t_out[row] = t;
    f_out[row] = f;
  }
}

}  // namespace

// ``arm`` (an ArmArgs, or null for the bits rounds on the dense planes)
// selects the watched arm or the gather rounds; the dense planes are not
// read under an arm and may be null.
extern "C" int deppy_bcp_fixpoint(const void* pos, const void* neg,
                                  const void* mem, const void* act,
                                  const void* card_n, const void* min_bits,
                                  const void* min_w, const void* t0,
                                  const void* f0, const void* en,
                                  void* conflict, void* t_out, void* f_out,
                                  int B, int C, int NA, int W, int threads,
                                  const void* arm, void* stream) {
  if (B == 0) return 0;
  if (!launch_ok(C, 0, threads)) return (int)cudaErrorInvalidValue;
  const ArmArgs A = arm_args(arm);
  const size_t smem =
      arm_smem_bytes(work_words(W, NA) * sizeof(uint32_t), W, NA, A);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bcp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  bcp_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pos), static_cast<const uint32_t*>(neg),
      static_cast<const uint32_t*>(mem), static_cast<const int*>(act),
      static_cast<const int*>(card_n),
      static_cast<const uint32_t*>(min_bits), static_cast<const int*>(min_w),
      static_cast<const uint32_t*>(t0), static_cast<const uint32_t*>(f0),
      static_cast<const int*>(en), static_cast<int*>(conflict),
      static_cast<uint32_t*>(t_out), static_cast<uint32_t*>(f_out), C, NA, W,
      A);
  return (int)cudaGetLastError();
}

// Shared bytes of one problem's slice under the warp team
// (cuda_search.warp_smem_bytes("bcp", ...)).
extern "C" size_t deppy_bcp_warp_smem_bytes(int C, int NA, int W) {
  return warp_slice_bytes(warp_work_words(C, NA, W));
}

// The warp team: ``warps`` problems per block, arguments as for
// deppy_bcp_fixpoint.
extern "C" int deppy_bcp_warp(const void* pos, const void* neg,
                              const void* mem, const void* act,
                              const void* card_n, const void* min_bits,
                              const void* min_w, const void* t0,
                              const void* f0, const void* en, void* conflict,
                              void* t_out, void* f_out, int B, int C, int NA,
                              int W, int warps, void* stream) {
  if (B == 0) return 0;
  const size_t slice = deppy_bcp_warp_smem_bytes(C, NA, W);
  const size_t smem = slice * (size_t)warps;
  if (W < 1 || W > 32 || warps < 1 || warps > kMaxWarps ||
      smem > (size_t)kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  decltype(&bcp_warp_kernel<1>) kernel;
  switch (warp_words_bound(W)) {
    case 1: kernel = bcp_warp_kernel<1>; break;
    case 2: kernel = bcp_warp_kernel<2>; break;
    case 4: kernel = bcp_warp_kernel<4>; break;
    case 8: kernel = bcp_warp_kernel<8>; break;
    case 16: kernel = bcp_warp_kernel<16>; break;
    default: kernel = bcp_warp_kernel<32>; break;
  }
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + warps - 1) / warps;
  kernel<<<blocks, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pos), static_cast<const uint32_t*>(neg),
      static_cast<const uint32_t*>(mem), static_cast<const int*>(act),
      static_cast<const int*>(card_n),
      static_cast<const uint32_t*>(min_bits), static_cast<const int*>(min_w),
      static_cast<const uint32_t*>(t0), static_cast<const uint32_t*>(f0),
      static_cast<const int*>(en), static_cast<int*>(conflict),
      static_cast<uint32_t*>(t_out), static_cast<uint32_t*>(f_out), B, C, NA,
      W, slice / sizeof(uint32_t));
  return (int)cudaGetLastError();
}
