// Kernel 4: phase 2, extras-only cardinality minimization.
//
// Replaces deppy_tpu/engine/pallas_search.py:_min_kernel (:520; entry
// batched_minimize_fused :650, pallas_call :616): binary search for the
// least w in [0, n_extras] such that a model with at most w extras exists,
// each probe a block-wide DPLL (dpll.cuh) with the dynamic "at most w of
// the extras" row, then one last probe at the minimal w when the last SAT
// probe was at another bound, so the model comes from that bound.
//
// Bound on the H100: log2(n_extras) + 1 DPLL probes per problem, each a
// chain of fixpoints whose rounds re-read the problem's reduced planes
// from L2; latency per problem, one block per problem across the batch.
#include <cuda_runtime.h>

#include "dpll.cuh"

namespace {

using namespace deppy;

struct MinCtl {
  int lo, hi, best_w, found, steps;
};

__global__ void minimize_kernel(
    const uint32_t* __restrict__ pos, const uint32_t* __restrict__ neg,
    const uint32_t* __restrict__ mem, const int* __restrict__ card_n,
    const int* __restrict__ card_valid, const uint32_t* __restrict__ m_init_t,
    const uint32_t* __restrict__ m_init_f, const uint32_t* __restrict__ extras,
    const uint32_t* __restrict__ m2t0, const uint32_t* __restrict__ pvb_all,
    const int* __restrict__ en_in, const int* __restrict__ n_extras_in,
    const int* __restrict__ steps_in, int budget, uint32_t* scratch,
    size_t scratch_words, int* found_out, int* steps_out, uint32_t* m2t_out,
    int C, int NA, int W, int NV) {
  extern __shared__ uint32_t smem[];
  __shared__ MinCtl ctl;
  __shared__ DpllCtl dctl;
  const int b = blockIdx.x;
  const bool lead = threadIdx.x == 0;
  const Work S = carve_work(smem, W, NA);
  uint32_t* m2_t = smem + work_words(W, NA);
  uint32_t* pm_t = m2_t + W;
  uint32_t* pm_f = pm_t + W;

  Planes P;
  P.pos = pos + (size_t)b * C * W;
  P.neg = neg + (size_t)b * C * W;
  P.mem = mem + (size_t)b * NA * W;
  P.card_n = card_n + (size_t)b * NA;
  P.card_valid = card_valid + (size_t)b * NA;
  P.card_act_bits = nullptr;
  P.C = C;
  P.NA = NA;
  P.W = W;
  const uint32_t* it = m_init_t + (size_t)b * W;
  const uint32_t* iff = m_init_f + (size_t)b * W;
  const uint32_t* ext = extras + (size_t)b * W;
  const uint32_t* pvb = pvb_all + (size_t)b * W;
  const DpllScratch D = carve_dpll(scratch + b * scratch_words, NV, W);
  const bool en = en_in[b] != 0;
  const int n_extras = n_extras_in[b];

  if (lead) {
    ctl.lo = 0;
    ctl.hi = n_extras;
    ctl.best_w = -1;
    ctl.found = 0;
    ctl.steps = steps_in[b];
    copy_words(m2_t, m2t0 + (size_t)b * W, W);
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
    if (lead) {
      if (status == kSat) {
        ctl.best_w = w;
        copy_words(m2_t, pm_t, W);
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
  if (lead) {
    if (need_final && f_status == kSat) copy_words(m2_t, pm_t, W);
    const bool found = (need_final ? f_status == kSat : ctl.found != 0) ||
                       (en && n_extras == 0);
    found_out[b] = found ? 1 : 0;
    steps_out[b] = ctl.steps;
    copy_words(m2t_out + (size_t)b * W, m2_t, W);
  }
}

}  // namespace

extern "C" size_t deppy_minimize_scratch_words(int NV, int W) {
  return dpll_scratch_words(NV, W);
}

extern "C" int deppy_minimize(const void* pos, const void* neg,
                              const void* mem, const void* card_n,
                              const void* card_valid, const void* m_init_t,
                              const void* m_init_f, const void* extras,
                              const void* m2t0, const void* pvb,
                              const void* en, const void* n_extras,
                              const void* steps, int budget, void* scratch,
                              void* found, void* steps_out, void* m2_t, int B,
                              int C, int NA, int W, int NV, int threads,
                              void* stream) {
  if (B == 0) return 0;
  const size_t smem = (work_words(W, NA) + 3 * (size_t)W) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        minimize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  minimize_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pos), static_cast<const uint32_t*>(neg),
      static_cast<const uint32_t*>(mem), static_cast<const int*>(card_n),
      static_cast<const int*>(card_valid),
      static_cast<const uint32_t*>(m_init_t),
      static_cast<const uint32_t*>(m_init_f),
      static_cast<const uint32_t*>(extras), static_cast<const uint32_t*>(m2t0),
      static_cast<const uint32_t*>(pvb), static_cast<const int*>(en),
      static_cast<const int*>(n_extras), static_cast<const int*>(steps),
      budget, static_cast<uint32_t*>(scratch), dpll_scratch_words(NV, W),
      static_cast<int*>(found), static_cast<int*>(steps_out),
      static_cast<uint32_t*>(m2_t), C, NA, W, NV);
  return (int)cudaGetLastError();
}
