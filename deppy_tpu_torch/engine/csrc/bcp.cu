// Kernel 1: batched BCP to a fixpoint.
//
// Replaces deppy_tpu/engine/pallas_bcp.py:_kernel (:50; entry bcp_fixpoint
// :79, pallas_call :92): loop the propagation round until nothing changes
// or a conflict appears.  No entry-overlap check, as in the Pallas kernel;
// the caller folds that in (core.planes_fixpoint).
//
// Bound on the H100: per problem the block re-reads its clause planes
// (2*C*W words) once per round, so a fixpoint moves rounds x planes bytes
// through L2/L1, while the bytes it must move at least once are the planes
// plus the two assignment planes.  Rounds are a chain (each depends on the
// last), so a problem's latency is rounds x (row scan + three barriers);
// the batch fills the card with one block per problem.  The design keeps
// the assignment and accumulators in shared memory and streams the planes
// from L2; keeping planes resident in shared memory is later speed work.
#include <cuda_runtime.h>

#include "fixpoint.cuh"

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
                           int W) {
  extern __shared__ uint32_t smem[];
  const int b = blockIdx.x;
  const Work S = carve_work(smem, W, NA);
  Planes P;
  P.pos = pos + (size_t)b * C * W;
  P.neg = neg + (size_t)b * C * W;
  P.mem = mem + (size_t)b * NA * W;
  P.card_n = card_n + (size_t)b * NA;
  P.card_valid = act + (size_t)b * NA;
  P.card_act = nullptr;
  P.C = C;
  P.NA = NA;
  P.W = W;
  P.tile_rows = 0;
  block_copy(S.t, t0 + (size_t)b * W, W);
  block_copy(S.f, f0 + (size_t)b * W, W);
  const bool c = block_fixpoint(P, S, min_bits + (size_t)b * W, min_w[b],
                                en[b] != 0, false);
  if (threadIdx.x == 0) conflict[b] = c ? 1 : 0;
  block_copy(t_out + (size_t)b * W, S.t, W);
  block_copy(f_out + (size_t)b * W, S.f, W);
}

}  // namespace

extern "C" int deppy_bcp_fixpoint(const void* pos, const void* neg,
                                  const void* mem, const void* act,
                                  const void* card_n, const void* min_bits,
                                  const void* min_w, const void* t0,
                                  const void* f0, const void* en,
                                  void* conflict, void* t_out, void* f_out,
                                  int B, int C, int NA, int W, int threads,
                                  void* stream) {
  if (B == 0) return 0;
  const size_t smem = work_words(W, NA) * sizeof(uint32_t);
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
      static_cast<uint32_t*>(t_out), static_cast<uint32_t*>(f_out), C, NA, W);
  return (int)cudaGetLastError();
}
