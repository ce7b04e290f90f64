// Kernels 7 and 8: the speculative core's single-drop probes.
//
// Replaces the reference's vmapped XLA probes, which have no pallas_call
// site of their own: deppy_tpu/engine/core.py:1754 (probe_fixpoint_phase,
// vmapped by batched_probe_fixpoint :1777) and :1786 (probe_phase, vmapped
// by batched_probe :1803), both driven by the deletion sweep of
// deppy_tpu/engine/driver.py:_speculative_core_mask (:672).
//
// One problem is shared by every lane: the plane pointers (or the compact
// rows, or the arm's rows and bank) carry no lane offset, so 512 lanes read
// one copy of the problem, which L2 holds.  One thread block runs one lane:
//
// * probe_fixpoint_kernel (stage 1): lane b builds the base assignment of
//   "every applied constraint active but drops[b]" in shared memory (a
//   disabled activation unassigned, padding false, anchors not assumed)
//   and runs the fixpoint with no extras bound; conflict[b] is 1 when it
//   conflicts.  A lane with drops[b] >= n_cons probes the full set.
// * probe_dpll_kernel (stage 2 and the verification probe): lane b builds
//   the base assignment of its packed activation mask, runs block_dpll
//   from 0 steps under ``budget`` with its snapshots in its slice of the
//   global scratch, and writes status[b] and steps[b].
//
// Every impl that kernel 5's block team takes, these take too: the dense
// rounds (bits, pallas, watched on dummy banks), the blockwise sweeps on
// compact rows (tile_rows > 0) and the watched and gather arms (set_arm),
// all through blockwise.cuh ``fixpoint``, in the full plane space.
//
// Bound on the H100: a lane is a chain of dependent rounds on one SM (a
// stage-1 lane one fixpoint, a stage-2 lane one per step); the lanes run
// side by side, so a launch takes about its longest lane, and the bytes
// are one read of the shared problem (L2 serves every other lane's).
#include <cuda_runtime.h>

#include "dpll.cuh"

namespace {

using namespace deppy;

// Lane b's base assignment into (t, f) over W words of the full space
// V = NV + NCON (core._base_assignment): problem variables unassigned,
// activation j of the ``n_cons`` applied constraints true when
// ``enabled(j)`` and unassigned otherwise, the rest of the space false,
// bits past V in neither plane.  ``pvb`` (when given) gets the problem
// variables.  Block-wide; the caller's next barrier publishes it.
template <typename Enabled>
__device__ void probe_entry(uint32_t* t, uint32_t* f, uint32_t* pvb, int W,
                            int V, int n_vars, int n_cons, Enabled enabled) {
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    uint32_t tw = 0u, fw = 0u, pw = 0u;
    for (int i = 0; i < 32; ++i) {
      const int v = w * 32 + i;
      if (v >= V) break;
      if (v < n_vars) {
        pw |= 1u << i;
      } else if (v < n_vars + n_cons) {
        if (enabled(v - n_vars)) tw |= 1u << i;
      } else {
        fw |= 1u << i;
      }
    }
    t[w] = tw;
    f[w] = fw;
    if (pvb != nullptr) pvb[w] = pw;
  }
}

// The shared problem's Planes (lane offset 0 everywhere).
__device__ inline Planes shared_planes(
    const uint32_t* pos, const uint32_t* neg, const uint32_t* mem,
    const int* card_n, const int* card_act, const Planes& L,
    const ArmArgs& A, uint32_t* smem, int C, int NA, int W) {
  Planes P{};
  P.pos = pos;
  P.neg = neg;
  P.mem = mem;
  P.card_n = card_n;
  P.C = C;
  P.NA = NA;
  P.W = W;
  set_activity(P, nullptr, card_act, 0);
  set_compact(P, L, smem, 0);
  set_arm(P, A, smem, 0);
  return P;
}

__global__ void __launch_bounds__(kMaxThreads) probe_fixpoint_kernel(
    const uint32_t* __restrict__ pos, const uint32_t* __restrict__ neg,
    const uint32_t* __restrict__ mem, const int* __restrict__ card_n,
    const int* __restrict__ card_act, Planes L, const int* n_vars_in,
    const int* n_cons_in, const int* __restrict__ drops, int* conflict_out,
    int C, int NA, int W, int V, ArmArgs A) {
  extern __shared__ uint32_t smem[];
  const int b = blockIdx.x;
  const Work S = carve_work(smem, W, NA);
  const Planes P =
      shared_planes(pos, neg, mem, card_n, card_act, L, A, smem, C, NA, W);
  stage_compact(P);
  const int n_vars = n_vars_in[0], n_cons = n_cons_in[0];
  const int drop = drops[b];
  probe_entry(S.t, S.f, nullptr, W, V, n_vars, n_cons,
              [drop](int j) { return j != drop; });
  // The fixpoint's entry barrier publishes the entry planes.
  const bool conflict = fixpoint(P, S, nullptr, 0, true, true);
  if (threadIdx.x == 0) conflict_out[b] = conflict ? 1 : 0;
}

__global__ void __launch_bounds__(kMaxThreads) probe_dpll_kernel(
    const uint32_t* __restrict__ pos, const uint32_t* __restrict__ neg,
    const uint32_t* __restrict__ mem, const int* __restrict__ card_n,
    const int* __restrict__ card_act, Planes L, const int* n_vars_in,
    const int* n_cons_in, const uint32_t* __restrict__ masks, int mask_words,
    int budget, uint32_t* scratch, size_t scratch_words, int* status_out,
    int* steps_out, int C, int NA, int W, int V, int NV, ArmArgs A) {
  extern __shared__ uint32_t smem[];
  __shared__ DpllCtl dctl;
  __shared__ int steps;
  const int b = blockIdx.x;
  const Work S = carve_work(smem, W, NA);
  uint32_t* init_t = smem + work_words(W, NA);
  uint32_t* init_f = init_t + W;
  uint32_t* pvb = init_f + W;
  uint32_t* pm_t = pvb + W;
  uint32_t* pm_f = pm_t + W;
  const Planes P =
      shared_planes(pos, neg, mem, card_n, card_act, L, A, smem, C, NA, W);
  stage_compact(P);
  const int n_vars = n_vars_in[0], n_cons = n_cons_in[0];
  const uint32_t* mask = masks + (size_t)b * mask_words;
  probe_entry(init_t, init_f, pvb, W, V, n_vars, n_cons,
              [mask](int j) { return ((mask[j >> 5] >> (j & 31)) & 1u) != 0u; });
  if (threadIdx.x == 0) steps = 0;
  const DpllScratch D = carve_dpll(scratch + (size_t)b * scratch_words, NV, W);
  // block_dpll's entry barrier publishes the entry planes and ``steps``.
  const int status = block_dpll(P, S, &dctl, D, pvb, init_t, init_f, nullptr,
                                0, budget, &steps, NV, true, pm_t, pm_f);
  if (threadIdx.x == 0) {
    status_out[b] = status;
    steps_out[b] = steps;
  }
}

// Dynamic shared bytes of either kernel: the Work and five planes (the
// phase kernels' layout, so the compact rows and the watched arm's words
// sit past tile_offset_words), or what the arm or the compact rows need.
inline size_t probe_smem_bytes(int W, int NA, const Planes& L,
                               const ArmArgs& A) {
  return arm_smem_bytes(
      kernel_smem_bytes(work_words(W, NA) + 5 * (size_t)W, L), W, NA, A);
}

}  // namespace

extern "C" size_t deppy_probe_scratch_words(int NV, int W) {
  return dpll_scratch_words(NV, W);
}

// Stage 1 over ``P`` lanes of one shared problem.  ``card_act``, the
// compact rows, ``tile_rows`` and ``arm`` as for deppy_core; ``n_vars``
// and ``n_cons`` point at the problem's counts; ``drops`` int32[P].
extern "C" int deppy_probe_fixpoint(
    const void* pos, const void* neg, const void* mem, const void* card_n,
    const void* card_act, const void* lits, const void* mlits,
    const void* n_vars, const void* n_cons, const void* drops, void* conflict,
    int lanes, int C, int NA, int W, int V, int K, int M, int lit_bytes,
    int tile_rows, int resident, int threads, const void* arm, void* stream) {
  if (lanes == 0) return 0;
  if (!launch_ok(C, tile_rows, threads) || V > 32 * W)
    return (int)cudaErrorInvalidValue;
  const Planes L = compact_dims(C, NA, W, lits, mlits, K, M, lit_bytes,
                                tile_rows, resident);
  const ArmArgs A = arm_args(arm);
  const size_t smem = probe_smem_bytes(W, NA, L, A);
  cudaError_t e = cudaFuncSetAttribute(
      probe_fixpoint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  probe_fixpoint_kernel<<<lanes, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pos), static_cast<const uint32_t*>(neg),
      static_cast<const uint32_t*>(mem), static_cast<const int*>(card_n),
      static_cast<const int*>(card_act), L, static_cast<const int*>(n_vars),
      static_cast<const int*>(n_cons), static_cast<const int*>(drops),
      static_cast<int*>(conflict), C, NA, W, V, A);
  return (int)cudaGetLastError();
}

// Stage 2 over ``Q`` lanes of one shared problem: ``masks`` [Q][mask_words]
// packed activation subsets, one ``budget``, ``scratch``
// [Q][deppy_probe_scratch_words]; the rest as for deppy_probe_fixpoint.
extern "C" int deppy_probe_dpll(
    const void* pos, const void* neg, const void* mem, const void* card_n,
    const void* card_act, const void* lits, const void* mlits,
    const void* n_vars, const void* n_cons, const void* masks, int mask_words,
    int budget, void* scratch, void* status, void* steps, int lanes, int C,
    int NA, int W, int V, int NV, int K, int M, int lit_bytes, int tile_rows,
    int resident, int threads, const void* arm, void* stream) {
  if (lanes == 0) return 0;
  if (!launch_ok(C, tile_rows, threads) || V > 32 * W || NV < 1 ||
      32 * mask_words < V - NV)
    return (int)cudaErrorInvalidValue;
  const Planes L = compact_dims(C, NA, W, lits, mlits, K, M, lit_bytes,
                                tile_rows, resident);
  const ArmArgs A = arm_args(arm);
  const size_t smem = probe_smem_bytes(W, NA, L, A);
  cudaError_t e = cudaFuncSetAttribute(
      probe_dpll_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  probe_dpll_kernel<<<lanes, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pos), static_cast<const uint32_t*>(neg),
      static_cast<const uint32_t*>(mem), static_cast<const int*>(card_n),
      static_cast<const int*>(card_act), L, static_cast<const int*>(n_vars),
      static_cast<const int*>(n_cons), static_cast<const uint32_t*>(masks),
      mask_words, budget, static_cast<uint32_t*>(scratch),
      dpll_scratch_words(NV, W), static_cast<int*>(status),
      static_cast<int*>(steps), C, NA, W, V, NV, A);
  return (int)cudaGetLastError();
}
