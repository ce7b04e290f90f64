// Kernel 2: batched blockwise BCP to a fixpoint.
//
// Replaces deppy_tpu/engine/pallas_blockwise.py:_kernel (:67; driven by
// _sweep :110, pallas_call :127, and bcp_fixpoint :147-190): Gauss-Seidel
// sweeps over tiles of clause rows, each tile run to its local fixpoint
// from shared memory (blockwise.cuh).  One thread block per problem; the
// Pallas kernel's sequential grid becomes the tile loop inside the block.
// It reads the compact rows (literal and member lists) of
// cuda_blockwise.compact_rows, never the dense planes.  No entry-overlap
// check, as in the Pallas kernel; the caller folds that in
// (cuda_search._baseline_fixpoint).
//
// Bound on the H100: the bytes it must move are the compact rows, read
// once, and the assignment planes; the operations are the rounds' literal
// tests.  A problem's latency is its chain of rounds (two barriers each)
// on one SM; the batch fills the card with one block per problem.
#include <cuda_runtime.h>

#include "blockwise.cuh"

namespace {

using namespace deppy;

__global__ void __launch_bounds__(kMaxThreads) blockwise_kernel(
    Planes L, const int* __restrict__ act, const int* __restrict__ card_n,
    const uint32_t* __restrict__ min_bits, const int* __restrict__ min_w,
    const uint32_t* __restrict__ t0, const uint32_t* __restrict__ f0,
    const int* __restrict__ en, int* conflict, uint32_t* t_out,
    uint32_t* f_out) {
  extern __shared__ uint32_t smem[];
  const int b = blockIdx.x;
  const int C = L.C, NA = L.NA, W = L.W;
  const Work S = carve_work(smem, W, NA);
  Planes P{};
  P.card_n = card_n + (size_t)b * NA;
  P.C = C;
  P.NA = NA;
  P.W = W;
  set_activity(P, act, nullptr, b);
  set_compact(P, L, smem, b);
  stage_compact(P);
  block_copy(S.t, t0 + (size_t)b * W, W);
  block_copy(S.f, f0 + (size_t)b * W, W);
  const bool c = fixpoint(P, S, min_bits + (size_t)b * W, min_w[b],
                          en[b] != 0, false);
  if (threadIdx.x == 0) conflict[b] = c ? 1 : 0;
  block_copy(t_out + (size_t)b * W, S.t, W);
  block_copy(f_out + (size_t)b * W, S.f, W);
}

}  // namespace

// ``lits`` [B][C][K] and ``mlits`` [B][NA][M] are the compact rows, of
// ``lit_bytes`` bytes each; ``act`` [B][NA] the static AtMost-row
// activity; ``tile_rows`` the rows per tile (at most C;
// cuda_blockwise.tile_rows); ``resident`` keeps every row in shared
// memory instead of streaming tiles.
extern "C" int deppy_blockwise_fixpoint(
    const void* lits, const void* mlits, const void* act, const void* card_n,
    const void* min_bits, const void* min_w, const void* t0, const void* f0,
    const void* en, void* conflict, void* t_out, void* f_out, int B, int C,
    int NA, int W, int K, int M, int lit_bytes, int tile_rows, int resident,
    int threads, void* stream) {
  if (B == 0) return 0;
  if (tile_rows < 1 || !launch_ok(C, tile_rows, threads))
    return (int)cudaErrorInvalidValue;
  const Planes L = compact_dims(C, NA, W, lits, mlits, K, M, lit_bytes,
                                tile_rows, resident);
  const size_t smem = kernel_smem_bytes(0, L);
  cudaError_t e = cudaFuncSetAttribute(
      blockwise_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  blockwise_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      L, static_cast<const int*>(act), static_cast<const int*>(card_n),
      static_cast<const uint32_t*>(min_bits), static_cast<const int*>(min_w),
      static_cast<const uint32_t*>(t0), static_cast<const uint32_t*>(f0),
      static_cast<const int*>(en), static_cast<int*>(conflict),
      static_cast<uint32_t*>(t_out), static_cast<uint32_t*>(f_out));
  return (int)cudaGetLastError();
}
