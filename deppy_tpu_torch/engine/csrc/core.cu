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
// Two teams compute the same function (cuda_search.team picks one per
// launch):
//
// * core_warp_kernel, the bits fixpoint at W <= 32 words when the planes
//   fit the per-problem shared budget (every bits-path launch of the main
//   path): one warp per problem, several per block, on warp.cuh.  The
//   base planes, pvb, the dropped set and the probe's trial live in
//   registers, one word per lane; the probe's candidates are set
//   lane-parallel (lane g holds candidate g); ``active`` lives in the
//   warp's slice and reaches core_out once, at the end; the chunk control
//   is held uniformly by every lane.  No block barrier.
// * core_kernel, one thread block per problem (fixpoint.cuh, dpll.cuh):
//   every blockwise, watched and gather launch (the full-space bank under
//   watched), and any shape the warp team refuses.  Plane copies and the
//   probe's entry planes are block-wide passes; thread 0 keeps the chunk
//   control.
//
// Bound on the H100: ceil(n_cons / G) chunk probes plus G member probes per
// SAT chunk, each a full DPLL over the full-space planes; latency per
// problem, a chain of dependent rounds on one SM.
#include <cuda_runtime.h>

#include "warp.cuh"

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
    int NV, int NCON, int G, ArmArgs A) {
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

  Planes P{};
  P.pos = pos + (size_t)b * C * W;
  P.neg = neg + (size_t)b * C * W;
  P.mem = mem + (size_t)b * NA * W;
  P.card_n = card_n + (size_t)b * NA;
  P.C = C;
  P.NA = NA;
  P.W = W;
  set_activity(P, nullptr, card_act, b);
  set_compact(P, L, smem, b);
  set_arm(P, A, smem, b);
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

// The warp team: warp b % WARPS of block b / WARPS owns problem b.
// ``slice_words`` per warp: warp_work_words, ``active`` [NCON], then the
// DPLL snapshots when ``snapshots`` (else they sit in ``scratch``).
// WMAX: warp_words_bound(W).
template <int WMAX>
__global__ void __launch_bounds__(32 * kMaxWarps) core_warp_kernel(
    const uint32_t* __restrict__ pos, const uint32_t* __restrict__ neg,
    const uint32_t* __restrict__ mem, const int* __restrict__ card_n,
    const int* __restrict__ card_act, const uint32_t* __restrict__ pvb_all,
    const uint32_t* __restrict__ base_t, const uint32_t* __restrict__ base_f,
    const int* __restrict__ en_in, const int* __restrict__ ncons_in,
    const int* __restrict__ nvars_in, const int* __restrict__ steps_in,
    int budget, uint32_t* scratch, size_t scratch_words, int* core_out,
    int* steps_out, int B, int C, int NA, int W, int NV, int NCON, int G,
    size_t slice_words, int snapshots) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp: no block barrier follows
  const bool en = en_in[b] != 0;
  const int n_cons = ncons_in[b];
  const int n_vars = nvars_in[b];
  int steps = steps_in[b];
  if (!(en && n_cons > 0 && steps <= budget)) {
    // No probe runs: the initial core, and no plane is staged.
    for (int i = lane; i < NCON; i += 32)
      core_out[(size_t)b * NCON + i] = (i < n_cons && en) ? 1 : 0;
    if (lane == 0) steps_out[b] = steps;
    return;
  }
  uint32_t* slice = smem + (size_t)warp * slice_words;
  const WarpPlanes P = warp_stage(slice, pos, neg, mem, card_n, nullptr,
                                  card_act, C, NA, W, b, lane);
  int* active = reinterpret_cast<int*>(slice + warp_work_words(C, NA, W));
  const DpllScratch D = carve_dpll(
      snapshots ? reinterpret_cast<uint32_t*>(active + NCON)
                : scratch + (size_t)b * scratch_words,
      NV, W);
  const bool own = lane < W;
  const size_t row = (size_t)b * W + lane;
  const uint32_t bt = own ? base_t[row] : 0u;
  const uint32_t bf = own ? base_f[row] : 0u;
  const uint32_t pvb = own ? pvb_all[row] : 0u;

  for (int i = lane; i < NCON; i += 32) active[i] = i < n_cons ? 1 : 0;
  __syncwarp();
  uint32_t dropped = 0u;
  int j = 0, k = 0;
  bool chunk_mode = true;
  while (en && j < n_cons && steps <= budget) {
    // Trial: the dropped set plus this probe's candidates (lane g < G
    // holds candidate g), cleared from the all-active activation bits.
    // The candidates' variables are consecutive, G <= 32 of them from
    // n_vars + j, so they span the words w0 and w0 + 1.
    int idx = -1;
    if (chunk_mode) {
      if (lane < G && j + lane < n_cons && active[j + lane]) idx = j + lane;
    } else if (lane == 0 && j + k < n_cons) {
      idx = j + k;
    }
    const int w0 = (n_vars + j) >> 5;
    const int v = n_vars + idx;
    const uint32_t bit = idx >= 0 ? 1u << (v & 31) : 0u;
    const bool upper = idx >= 0 && (v >> 5) != w0;
    const uint32_t x0 = __reduce_or_sync(kFullMask, upper ? 0u : bit);
    const uint32_t x1 = __reduce_or_sync(kFullMask, upper ? bit : 0u);
    uint32_t trial = dropped;
    if (lane == w0) trial |= x0;
    if (lane == w0 + 1) trial |= x1;
    uint32_t pm_t, pm_f;
    const int status =
        warp_dpll<WMAX, false>(P, D, pvb, bt & ~trial, bf, 0u, 0, budget,
                               steps, NV, true, pm_t, pm_f, lane);
    const bool unsat = status == kUnsat;
    if (unsat) {
      dropped = trial;
      if (chunk_mode) {
        if (lane < G && j + lane < NCON) active[j + lane] = 0;
      } else if (lane == 0 && j + k < n_cons) {
        active[j + k] = 0;
      }
    }
    int k2 = chunk_mode ? 0 : k + 1;
    const bool advance = (chunk_mode && unsat) ||
                         (!chunk_mode && (k2 >= G || j + k2 >= n_cons));
    if (advance) {
      j += G;
      k2 = 0;
    }
    k = k2;
    chunk_mode = advance;
  }
  __syncwarp();
  for (int i = lane; i < NCON; i += 32)
    core_out[(size_t)b * NCON + i] = active[i];
  if (lane == 0) steps_out[b] = steps;
}

}  // namespace

extern "C" size_t deppy_core_scratch_words(int NV, int W) {
  return dpll_scratch_words(NV, W);
}

// ``card_act``, the compact rows, ``tile_rows`` and ``arm`` as for
// deppy_search.
extern "C" int deppy_core(
    const void* pos, const void* neg, const void* mem, const void* card_n,
    const void* card_act, const void* lits, const void* mlits,
    const void* pvb, const void* base_t, const void* base_f, const void* en,
    const void* n_cons, const void* n_vars, const void* steps, int budget,
    void* scratch, void* core, void* steps_out, int B, int C, int NA, int W,
    int NV, int NCON, int G, int K, int M, int lit_bytes, int tile_rows,
    int resident, int threads, const void* arm, void* stream) {
  if (B == 0) return 0;
  if (!launch_ok(C, tile_rows, threads)) return (int)cudaErrorInvalidValue;
  const Planes L = compact_dims(C, NA, W, lits, mlits, K, M, lit_bytes,
                                tile_rows, resident);
  const ArmArgs A = arm_args(arm);
  const size_t smem = arm_smem_bytes(
      kernel_smem_bytes(work_words(W, NA) + 5 * (size_t)W, L), W, NA, A);
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
      static_cast<int*>(steps_out), C, NA, W, NV, NCON, G, A);
  return (int)cudaGetLastError();
}

// Shared bytes of one problem's slice under the warp team: the warp's work
// words and ``active`` [NCON], plus the DPLL snapshots when ``snapshots``.
extern "C" size_t deppy_core_warp_smem_bytes(int C, int NA, int W, int NV,
                                             int NCON, int snapshots) {
  return warp_slice_bytes(warp_work_words(C, NA, W) + (size_t)NCON +
                          (snapshots ? dpll_scratch_words(NV, W) : 0));
}

// The warp team on the bits fixpoint's dense planes: ``warps`` problems per
// block, the snapshots in each warp's slice when ``snapshots``, else in
// ``scratch`` [B][deppy_core_scratch_words].
extern "C" int deppy_core_warp(
    const void* pos, const void* neg, const void* mem, const void* card_n,
    const void* card_act, const void* pvb, const void* base_t,
    const void* base_f, const void* en, const void* n_cons,
    const void* n_vars, const void* steps, int budget, void* scratch,
    void* core, void* steps_out, int B, int C, int NA, int W, int NV, int NCON,
    int G, int warps, int snapshots, void* stream) {
  if (B == 0) return 0;
  const size_t slice =
      deppy_core_warp_smem_bytes(C, NA, W, NV, NCON, snapshots);
  const size_t smem = slice * (size_t)warps;
  if (W < 1 || W > 32 || G < 1 || G > 32 || warps < 1 ||
      warps > kMaxWarps || smem > (size_t)kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  decltype(&core_warp_kernel<1>) kernel;
  switch (warp_words_bound(W)) {
    case 1: kernel = core_warp_kernel<1>; break;
    case 2: kernel = core_warp_kernel<2>; break;
    case 4: kernel = core_warp_kernel<4>; break;
    case 8: kernel = core_warp_kernel<8>; break;
    case 16: kernel = core_warp_kernel<16>; break;
    default: kernel = core_warp_kernel<32>; break;
  }
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (B + warps - 1) / warps;
  kernel<<<blocks, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pos), static_cast<const uint32_t*>(neg),
      static_cast<const uint32_t*>(mem), static_cast<const int*>(card_n),
      static_cast<const int*>(card_act), static_cast<const uint32_t*>(pvb),
      static_cast<const uint32_t*>(base_t),
      static_cast<const uint32_t*>(base_f), static_cast<const int*>(en),
      static_cast<const int*>(n_cons), static_cast<const int*>(n_vars),
      static_cast<const int*>(steps), budget, static_cast<uint32_t*>(scratch),
      snapshots ? 0 : dpll_scratch_words(NV, W), static_cast<int*>(core),
      static_cast<int*>(steps_out), B, C, NA, W, NV, NCON, G,
      slice / sizeof(uint32_t), snapshots);
  return (int)cudaGetLastError();
}
