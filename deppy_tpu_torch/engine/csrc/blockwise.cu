// Kernel 2: batched blockwise BCP to a fixpoint.
//
// Replaces deppy_tpu/engine/pallas_blockwise.py:_kernel (:67; driven by
// _sweep :110, pallas_call :127, and bcp_fixpoint :147-190): Gauss-Seidel
// sweeps over tiles of clause rows, each tile run to its local fixpoint
// from shared memory (blockwise.cuh).  One thread block per problem; the
// Pallas kernel's sequential grid becomes the tile loop inside the block.
// No entry-overlap check, as in the Pallas kernel; the caller folds that
// in (cuda_blockwise.planes_fixpoint).
//
// Bound on the H100: each sweep moves the problem's clause planes (2*C*W
// words) from device memory through one SM once, so a fixpoint costs
// sweeps x planes bytes, and a problem's latency is that stream plus one
// round (three barriers) per tile at least.  Problems past the L2 (the
// giant catalog's 48 MiB of planes) stream from HBM at one SM's share of
// the bandwidth; the batch fills the card with one block per problem.
#include <cuda_runtime.h>

#include "blockwise.cuh"

namespace {

using namespace deppy;

__global__ void blockwise_kernel(const uint32_t* __restrict__ pos,
                                 const uint32_t* __restrict__ neg,
                                 const uint32_t* __restrict__ mem,
                                 const int* __restrict__ act,
                                 const int* __restrict__ card_n,
                                 const uint32_t* __restrict__ min_bits,
                                 const int* __restrict__ min_w,
                                 const uint32_t* __restrict__ t0,
                                 const uint32_t* __restrict__ f0,
                                 const int* __restrict__ en, int* conflict,
                                 uint32_t* t_out, uint32_t* f_out, int C,
                                 int NA, int W, int tile_rows) {
  extern __shared__ uint32_t smem[];
  const int b = blockIdx.x;
  const Work S = carve_work(smem, W, NA);
  Planes P;
  P.pos = pos + (size_t)b * C * W;
  P.neg = neg + (size_t)b * C * W;
  P.mem = mem + (size_t)b * NA * W;
  P.card_n = card_n + (size_t)b * NA;
  P.C = C;
  P.NA = NA;
  P.W = W;
  set_activity(P, act, nullptr, b);
  P.tile_rows = tile_rows;
  P.tile = smem + tile_offset_words(W, NA);
  if (threadIdx.x == 0) {
    copy_words(S.t, t0 + (size_t)b * W, W);
    copy_words(S.f, f0 + (size_t)b * W, W);
  }
  const bool c = block_fixpoint_blockwise(P, S, min_bits + (size_t)b * W,
                                          min_w[b], en[b] != 0, false);
  if (threadIdx.x == 0) {
    conflict[b] = c ? 1 : 0;
    copy_words(t_out + (size_t)b * W, S.t, W);
    copy_words(f_out + (size_t)b * W, S.f, W);
  }
}

}  // namespace

// The signature of deppy_bcp_fixpoint plus the tile height ``block_rows``
// (rows per shared-memory tile, at most C; cuda_blockwise.tile_rows).
extern "C" int deppy_blockwise_fixpoint(
    const void* pos, const void* neg, const void* mem, const void* act,
    const void* card_n, const void* min_bits, const void* min_w,
    const void* t0, const void* f0, const void* en, void* conflict,
    void* t_out, void* f_out, int B, int C, int NA, int W, int block_rows,
    int threads, void* stream) {
  if (B == 0) return 0;
  if (block_rows < 1 || block_rows > C || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = kernel_smem_bytes(0, W, NA, block_rows);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        blockwise_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  blockwise_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pos), static_cast<const uint32_t*>(neg),
      static_cast<const uint32_t*>(mem), static_cast<const int*>(act),
      static_cast<const int*>(card_n),
      static_cast<const uint32_t*>(min_bits), static_cast<const int*>(min_w),
      static_cast<const uint32_t*>(t0), static_cast<const uint32_t*>(f0),
      static_cast<const int*>(en), static_cast<int*>(conflict),
      static_cast<uint32_t*>(t_out), static_cast<uint32_t*>(f_out), C, NA, W,
      block_rows);
  return (int)cudaGetLastError();
}
