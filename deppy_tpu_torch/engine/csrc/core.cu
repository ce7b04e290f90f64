// Kernel 5: phase 3, the deletion unsat core.
//
// Replaces deppy_tpu/engine/pallas_search.py:_core_kernel (:676; entry
// batched_core_fused :818, pallas_call :785): starting from every applied
// constraint active, drop each whose removal keeps the rest UNSAT.  Chunks
// of CORE_CHUNK constraints are probed whole first and member by member
// only after a SAT chunk probe.  Probes run in the full plane space, where
// activation literals are variables: a probe clears the activation bits of
// the dropped constraints, and AtMost-row activity follows the activation
// variable of each fixpoint's entry state (Planes::card_act).
//
// Every fixpoint is the bits rounds or, under the blockwise impl, a
// blockwise sweep over compact rows (Planes::tile_rows).  Plane copies and
// the probe's entry planes are block-wide passes; thread 0 keeps the
// chunk control.
//
// Bound on the H100: ceil(n_cons / G) chunk probes plus G member probes per
// SAT chunk, each a full block-wide DPLL over the full-space planes, which
// re-read from L2 every round; latency per problem, one block per problem.
#include <cuda_runtime.h>

#include "dpll.cuh"

namespace {

using namespace deppy;

struct CoreCtl {
  int j, k, chunk_mode, steps;
};

__global__ void __launch_bounds__(kMaxThreads) core_kernel(
    const uint32_t* __restrict__ pos, const uint32_t* __restrict__ neg,
    const uint32_t* __restrict__ mem, const int* __restrict__ card_n,
    const int* __restrict__ card_act, Planes L,
    const uint32_t* __restrict__ pvb_all, const uint32_t* __restrict__ base_t,
    const uint32_t* __restrict__ base_f, const int* __restrict__ en_in,
    const int* __restrict__ ncons_in, const int* __restrict__ nvars_in,
    const int* __restrict__ steps_in, int budget, uint32_t* scratch,
    size_t scratch_words, int* core_out, int* steps_out, int C, int NA, int W,
    int NV, int NCON, int G) {
  extern __shared__ uint32_t smem[];
  __shared__ CoreCtl ctl;
  __shared__ DpllCtl dctl;
  const int b = blockIdx.x;
  const bool lead = threadIdx.x == 0;
  const Work S = carve_work(smem, W, NA);
  uint32_t* dropped = smem + work_words(W, NA);
  uint32_t* trial = dropped + W;
  uint32_t* init_t = trial + W;
  uint32_t* pm_t = init_t + W;
  uint32_t* pm_f = pm_t + W;

  Planes P;
  P.pos = pos + (size_t)b * C * W;
  P.neg = neg + (size_t)b * C * W;
  P.mem = mem + (size_t)b * NA * W;
  P.card_n = card_n + (size_t)b * NA;
  P.C = C;
  P.NA = NA;
  P.W = W;
  set_activity(P, nullptr, card_act, b);
  set_compact(P, L, smem, b);
  stage_compact(P);
  const uint32_t* pvb = pvb_all + (size_t)b * W;
  const uint32_t* bt = base_t + (size_t)b * W;
  const uint32_t* bf = base_f + (size_t)b * W;
  int* active = core_out + (size_t)b * NCON;
  const DpllScratch D = carve_dpll(scratch + b * scratch_words, NV, W);
  const bool en = en_in[b] != 0;
  const int n_cons = ncons_in[b];
  const int n_vars = nvars_in[b];

  const int tid = threadIdx.x, nt = blockDim.x;
  for (int j = tid; j < NCON; j += nt) active[j] = (j < n_cons && en) ? 1 : 0;
  for (int w = tid; w < W; w += nt) dropped[w] = 0u;
  if (lead) {
    ctl.j = 0;
    ctl.k = 0;
    ctl.chunk_mode = 1;
    ctl.steps = steps_in[b];
  }
  while (true) {
    __syncthreads();
    const bool go = en && ctl.j < n_cons && ctl.steps <= budget;
    const int j = ctl.j, k = ctl.k;
    const bool chunk_mode = ctl.chunk_mode != 0;
    __syncthreads();
    if (!go) break;
    // Trial: the dropped set plus this probe's candidates, cleared from
    // the all-active activation bits.
    block_copy(trial, dropped, W);
    __syncthreads();
    if (lead) {
      if (chunk_mode) {
        for (int g = 0; g < G; ++g) {
          const int idx = j + g;
          if (idx < n_cons && active[idx]) {
            const int v = n_vars + idx;
            trial[v >> 5] |= 1u << (v & 31);
          }
        }
      } else if (j + k < n_cons) {
        const int v = n_vars + j + k;
        trial[v >> 5] |= 1u << (v & 31);
      }
    }
    __syncthreads();
    for (int w = tid; w < W; w += nt) init_t[w] = bt[w] & ~trial[w];
    const int status = block_dpll(P, S, &dctl, D, pvb, init_t, bf, nullptr,
                                  0, budget, &ctl.steps, NV, true, pm_t,
                                  pm_f);
    const bool unsat = status == kUnsat;
    if (unsat) block_copy(dropped, trial, W);
    if (lead) {
      if (unsat) {
        if (chunk_mode) {
          for (int g = 0; g < G && j + g < NCON; ++g) active[j + g] = 0;
        } else if (j + k < n_cons) {
          active[j + k] = 0;
        }
      }
      int k2 = chunk_mode ? 0 : k + 1;
      const bool advance = (chunk_mode && unsat) ||
                           (!chunk_mode && (k2 >= G || j + k2 >= n_cons));
      if (advance) {
        ctl.j = j + G;
        k2 = 0;
      }
      ctl.k = k2;
      ctl.chunk_mode = advance ? 1 : 0;
    }
  }
  if (lead) steps_out[b] = ctl.steps;
}

}  // namespace

extern "C" size_t deppy_core_scratch_words(int NV, int W) {
  return dpll_scratch_words(NV, W);
}

// ``card_act``, the compact rows and ``tile_rows`` as for deppy_search.
extern "C" int deppy_core(
    const void* pos, const void* neg, const void* mem, const void* card_n,
    const void* card_act, const void* lits, const void* mlits,
    const void* pvb, const void* base_t, const void* base_f, const void* en,
    const void* n_cons, const void* n_vars, const void* steps, int budget,
    void* scratch, void* core, void* steps_out, int B, int C, int NA, int W,
    int NV, int NCON, int G, int K, int M, int lit_bytes, int tile_rows,
    int resident, int threads, void* stream) {
  if (B == 0) return 0;
  if (!launch_ok(C, tile_rows, threads)) return (int)cudaErrorInvalidValue;
  const Planes L = compact_dims(C, NA, W, lits, mlits, K, M, lit_bytes,
                                tile_rows, resident);
  const size_t smem = kernel_smem_bytes(work_words(W, NA) + 5 * (size_t)W, L);
  cudaError_t e = cudaFuncSetAttribute(
      core_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  core_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pos), static_cast<const uint32_t*>(neg),
      static_cast<const uint32_t*>(mem), static_cast<const int*>(card_n),
      static_cast<const int*>(card_act), L,
      static_cast<const uint32_t*>(pvb), static_cast<const uint32_t*>(base_t),
      static_cast<const uint32_t*>(base_f), static_cast<const int*>(en),
      static_cast<const int*>(n_cons), static_cast<const int*>(n_vars),
      static_cast<const int*>(steps), budget, static_cast<uint32_t*>(scratch),
      dpll_scratch_words(NV, W), static_cast<int*>(core),
      static_cast<int*>(steps_out), C, NA, W, NV, NCON, G);
  return (int)cudaGetLastError();
}
