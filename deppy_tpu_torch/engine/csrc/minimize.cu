// Kernel 4: phase 2, extras-only cardinality minimization.
//
// Replaces deppy_tpu/engine/pallas_search.py:_min_kernel (:520; entry
// batched_minimize_fused :650, pallas_call :616): binary search for the
// least w in [0, n_extras] such that a model with at most w extras exists,
// each probe a DPLL with the dynamic "at most w of the extras" row, then
// one last probe at the minimal w when the last SAT probe was at another
// bound, so the model comes from that bound.
//
// Two teams compute the same function (cuda_search.team picks one per
// launch):
//
// * minimize_warp_kernel, the bits fixpoint in the reduced space at W <= 32
//   words when the planes fit the per-problem shared budget (every
//   bits-path launch of the main path): one warp per problem, several per
//   block, on warp.cuh.  m_init_t, m_init_f, the extras row and the best
//   model live in registers, one word per lane; the extras count is one
//   __popc per lane and a __reduce_add_sync; the binary search's lo, hi,
//   best_w, found and steps are held uniformly by every lane.
// * minimize_kernel, one thread block per problem (dpll.cuh): every
//   blockwise launch (full space, every fixpoint a blockwise sweep over
//   compact rows, Planes::tile_rows), every watched and gather launch
//   (their arms, watched.cuh, Planes::arm), and any shape the warp team
//   refuses.  Its plane copies are block-wide passes (fixpoint.cuh
//   block_copy).
//
// Bound on the H100: log2(n_extras) + 1 DPLL probes per problem, each a
// chain of dependent fixpoint rounds; latency per problem.
#include <cuda_runtime.h>

#include "warp.cuh"

namespace {

using namespace deppy;

struct MinCtl {
  int lo, hi, best_w, found, steps;
};

__global__ void __launch_bounds__(kMaxThreads) minimize_kernel(
    const uint32_t* __restrict__ pos, const uint32_t* __restrict__ neg,
    const uint32_t* __restrict__ mem, const int* __restrict__ card_n,
    const int* __restrict__ card_valid, const int* __restrict__ card_act,
    Planes L, const uint32_t* __restrict__ m_init_t,
    const uint32_t* __restrict__ m_init_f, const uint32_t* __restrict__ extras,
    const uint32_t* __restrict__ m2t0, const uint32_t* __restrict__ pvb_all,
    const int* __restrict__ en_in, const int* __restrict__ n_extras_in,
    const int* __restrict__ steps_in, int budget, uint32_t* scratch,
    size_t scratch_words, int* found_out, int* steps_out, uint32_t* m2t_out,
    int C, int NA, int W, int NV, ArmArgs A) {
  extern __shared__ uint32_t smem[];
  __shared__ MinCtl ctl;
  __shared__ DpllCtl dctl;
  const int b = blockIdx.x;
  const bool lead = threadIdx.x == 0;
  const Work S = carve_work(smem, W, NA);
  uint32_t* m2_t = smem + work_words(W, NA);
  uint32_t* pm_t = m2_t + W;
  uint32_t* pm_f = pm_t + W;

  Planes P{};
  P.pos = pos + (size_t)b * C * W;
  P.neg = neg + (size_t)b * C * W;
  P.mem = mem + (size_t)b * NA * W;
  P.card_n = card_n + (size_t)b * NA;
  P.C = C;
  P.NA = NA;
  P.W = W;
  set_activity(P, card_valid, card_act, b);
  set_compact(P, L, smem, b);
  set_arm(P, A, smem, b);
  stage_compact(P);
  const uint32_t* it = m_init_t + (size_t)b * W;
  const uint32_t* iff = m_init_f + (size_t)b * W;
  const uint32_t* ext = extras + (size_t)b * W;
  const uint32_t* pvb = pvb_all + (size_t)b * W;
  const DpllScratch D = carve_dpll(scratch + b * scratch_words, NV, W);
  const bool en = en_in[b] != 0;
  const int n_extras = n_extras_in[b];

  block_copy(m2_t, m2t0 + (size_t)b * W, W);
  if (lead) {
    ctl.lo = 0;
    ctl.hi = n_extras;
    ctl.best_w = -1;
    ctl.found = 0;
    ctl.steps = steps_in[b];
  }
  // Invariant: UNSAT strictly below lo, SAT at hi.
  while (true) {
    __syncthreads();
    const int lo = ctl.lo, hi = ctl.hi;
    const bool go = en && lo < hi && ctl.steps <= budget;
    __syncthreads();
    if (!go) break;
    const int w = (lo + hi) / 2;
    const int status = block_dpll(P, S, &dctl, D, pvb, it, iff, ext, w,
                                  budget, &ctl.steps, NV, en, pm_t, pm_f);
    if (status == kSat) block_copy(m2_t, pm_t, W);
    if (lead) {
      if (status == kSat) {
        ctl.best_w = w;
        ctl.found = 1;
        ctl.hi = w;
      } else if (status == kUnsat) {
        ctl.lo = w + 1;
      } else {
        ctl.lo = hi;  // budget exhausted: the steps guard exits
      }
    }
  }
  __syncthreads();
  const int m_hi = ctl.hi;
  const bool need_final = en && ctl.best_w != m_hi && n_extras > 0;
  const int f_status = block_dpll(P, S, &dctl, D, pvb, it, iff, ext, m_hi,
                                  budget, &ctl.steps, NV, need_final, pm_t,
                                  pm_f);
  if (need_final && f_status == kSat) block_copy(m2_t, pm_t, W);
  if (lead) {
    const bool found = (need_final ? f_status == kSat : ctl.found != 0) ||
                       (en && n_extras == 0);
    found_out[b] = found ? 1 : 0;
    steps_out[b] = ctl.steps;
  }
  __syncthreads();
  block_copy(m2t_out + (size_t)b * W, m2_t, W);
}

// The binary search of one enabled lane with extras, and its final probe
// (the block kernel's, with lo, hi, best_w, found and steps held uniformly
// by every lane).  Returns found; the model lands in m2_t.
template <int WMAX>
__device__ __forceinline__ bool minimize_probes(
    const WarpPlanes& P, const DpllScratch& D, uint32_t pvb, uint32_t it,
    uint32_t iff, uint32_t ext, int n_extras, int budget, int& steps, int NV,
    uint32_t& m2_t, int lane) {
  int lo = 0, hi = n_extras, best_w = -1;
  bool found = false;
  uint32_t pm_t, pm_f;
  // Invariant: UNSAT strictly below lo, SAT at hi.
  while (lo < hi && steps <= budget) {
    const int w = (lo + hi) / 2;
    const int status = warp_dpll<WMAX, true>(P, D, pvb, it, iff, ext, w,
                                             budget, steps, NV, true, pm_t,
                                             pm_f, lane);
    if (status == kSat) {
      m2_t = pm_t;
      best_w = w;
      found = true;
      hi = w;
    } else if (status == kUnsat) {
      lo = w + 1;
    } else {
      lo = hi;  // budget exhausted: the steps guard exits
    }
  }
  // The final probe at the minimal w, when the last SAT probe was at
  // another bound.
  if (best_w != hi) {
    found = warp_dpll<WMAX, true>(P, D, pvb, it, iff, ext, hi, budget, steps,
                                  NV, true, pm_t, pm_f, lane) == kSat;
    if (found) m2_t = pm_t;
  }
  return found;
}

// The warp team: warp b % WARPS of block b / WARPS owns problem b.
// ``slice_words`` per warp: warp_work_words, then the DPLL snapshots when
// ``snapshots`` (else they sit in ``scratch``).  WMAX: warp_words_bound(W).
template <int WMAX>
__global__ void __launch_bounds__(32 * kMaxWarps) minimize_warp_kernel(
    const uint32_t* __restrict__ pos, const uint32_t* __restrict__ neg,
    const uint32_t* __restrict__ mem, const int* __restrict__ card_n,
    const int* __restrict__ card_valid, const int* __restrict__ card_act,
    const uint32_t* __restrict__ m_init_t,
    const uint32_t* __restrict__ m_init_f, const uint32_t* __restrict__ extras,
    const uint32_t* __restrict__ m2t0, const uint32_t* __restrict__ pvb_all,
    const int* __restrict__ en_in, const int* __restrict__ n_extras_in,
    const int* __restrict__ steps_in, int budget, uint32_t* scratch,
    size_t scratch_words, int* found_out, int* steps_out, uint32_t* m2t_out,
    int B, int C, int NA, int W, int NV, size_t slice_words, int snapshots) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp: no block barrier follows
  const bool en = en_in[b] != 0;
  const int n_extras = n_extras_in[b];
  const bool own = lane < W;
  const size_t row = (size_t)b * W + lane;
  uint32_t m2_t = own ? m2t0[row] : 0u;
  int steps = steps_in[b];
  bool found = false;
  if (en && n_extras > 0) {
    uint32_t* slice = smem + (size_t)warp * slice_words;
    const WarpPlanes P = warp_stage(slice, pos, neg, mem, card_n, card_valid,
                                    card_act, C, NA, W, b, lane);
    const DpllScratch D = carve_dpll(
        snapshots ? slice + warp_work_words(C, NA, W)
                  : scratch + (size_t)b * scratch_words,
        NV, W);
    const uint32_t it = own ? m_init_t[row] : 0u;
    const uint32_t iff = own ? m_init_f[row] : 0u;
    const uint32_t ext = own ? extras[row] : 0u;
    const uint32_t pvb = own ? pvb_all[row] : 0u;
    found = minimize_probes<WMAX>(P, D, pvb, it, iff, ext, n_extras, budget,
                                  steps, NV, m2_t, lane);
  }
  if (lane == 0) {
    found_out[b] = (found || (en && n_extras == 0)) ? 1 : 0;
    steps_out[b] = steps;
  }
  if (own) m2t_out[row] = m2_t;
}

}  // namespace

extern "C" size_t deppy_minimize_scratch_words(int NV, int W) {
  return dpll_scratch_words(NV, W);
}

// ``card_valid`` / ``card_act``, the compact rows, ``tile_rows`` and
// ``arm`` as for deppy_search.
extern "C" int deppy_minimize(
    const void* pos, const void* neg, const void* mem, const void* card_n,
    const void* card_valid, const void* card_act, const void* lits,
    const void* mlits, const void* m_init_t, const void* m_init_f,
    const void* extras, const void* m2t0, const void* pvb, const void* en,
    const void* n_extras, const void* steps, int budget, void* scratch,
    void* found, void* steps_out, void* m2_t, int B, int C, int NA, int W,
    int NV, int K, int M, int lit_bytes, int tile_rows, int resident,
    int threads, const void* arm, void* stream) {
  if (B == 0) return 0;
  if (!launch_ok(C, tile_rows, threads)) return (int)cudaErrorInvalidValue;
  const Planes L = compact_dims(C, NA, W, lits, mlits, K, M, lit_bytes,
                                tile_rows, resident);
  const ArmArgs A = arm_args(arm);
  const size_t smem = arm_smem_bytes(
      kernel_smem_bytes(work_words(W, NA) + 3 * (size_t)W, L), W, NA, A);
  cudaError_t e = cudaFuncSetAttribute(
      minimize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  minimize_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pos), static_cast<const uint32_t*>(neg),
      static_cast<const uint32_t*>(mem), static_cast<const int*>(card_n),
      static_cast<const int*>(card_valid), static_cast<const int*>(card_act),
      L, static_cast<const uint32_t*>(m_init_t),
      static_cast<const uint32_t*>(m_init_f),
      static_cast<const uint32_t*>(extras), static_cast<const uint32_t*>(m2t0),
      static_cast<const uint32_t*>(pvb), static_cast<const int*>(en),
      static_cast<const int*>(n_extras), static_cast<const int*>(steps),
      budget, static_cast<uint32_t*>(scratch), dpll_scratch_words(NV, W),
      static_cast<int*>(found), static_cast<int*>(steps_out),
      static_cast<uint32_t*>(m2_t), C, NA, W, NV, A);
  return (int)cudaGetLastError();
}

// Shared bytes of one problem's slice under the warp team: the warp's work
// words, plus the DPLL snapshots when ``snapshots``.
extern "C" size_t deppy_minimize_warp_smem_bytes(int C, int NA, int W, int NV,
                                                 int snapshots) {
  return warp_slice_bytes(warp_work_words(C, NA, W) +
                          (snapshots ? dpll_scratch_words(NV, W) : 0));
}

// The warp team on the bits fixpoint's dense planes: ``warps`` problems per
// block, the snapshots in each warp's slice when ``snapshots``, else in
// ``scratch`` [B][deppy_minimize_scratch_words].  ``card_valid`` /
// ``card_act`` as for deppy_minimize.
extern "C" int deppy_minimize_warp(
    const void* pos, const void* neg, const void* mem, const void* card_n,
    const void* card_valid, const void* card_act, const void* m_init_t,
    const void* m_init_f, const void* extras, const void* m2t0,
    const void* pvb, const void* en, const void* n_extras, const void* steps,
    int budget, void* scratch, void* found, void* steps_out, void* m2_t,
    int B, int C, int NA, int W, int NV, int warps, int snapshots,
    void* stream) {
  if (B == 0) return 0;
  const size_t slice = deppy_minimize_warp_smem_bytes(C, NA, W, NV, snapshots);
  const size_t smem = slice * (size_t)warps;
  if (W < 1 || W > 32 || warps < 1 || warps > kMaxWarps ||
      smem > (size_t)kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  decltype(&minimize_warp_kernel<1>) kernel;
  switch (warp_words_bound(W)) {
    case 1: kernel = minimize_warp_kernel<1>; break;
    case 2: kernel = minimize_warp_kernel<2>; break;
    case 4: kernel = minimize_warp_kernel<4>; break;
    case 8: kernel = minimize_warp_kernel<8>; break;
    case 16: kernel = minimize_warp_kernel<16>; break;
    default: kernel = minimize_warp_kernel<32>; break;
  }
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (B + warps - 1) / warps;
  kernel<<<blocks, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pos), static_cast<const uint32_t*>(neg),
      static_cast<const uint32_t*>(mem), static_cast<const int*>(card_n),
      static_cast<const int*>(card_valid), static_cast<const int*>(card_act),
      static_cast<const uint32_t*>(m_init_t),
      static_cast<const uint32_t*>(m_init_f),
      static_cast<const uint32_t*>(extras), static_cast<const uint32_t*>(m2t0),
      static_cast<const uint32_t*>(pvb), static_cast<const int*>(en),
      static_cast<const int*>(n_extras), static_cast<const int*>(steps),
      budget, static_cast<uint32_t*>(scratch),
      snapshots ? 0 : dpll_scratch_words(NV, W), static_cast<int*>(found),
      static_cast<int*>(steps_out), static_cast<uint32_t*>(m2_t), B, C, NA, W,
      NV, slice / sizeof(uint32_t), snapshots);
  return (int)cudaGetLastError();
}
