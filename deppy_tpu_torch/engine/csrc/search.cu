// Kernel 3: phase 1, the preference-ordered guess search.
//
// Replaces deppy_tpu/engine/pallas_search.py:_kernel (:300; entry
// batched_search_fused :916, pallas_call :860).  The baseline fixpoint the
// Pallas kernel runs first is a launch of its own in this port (kernel 1,
// bcp.cu, under the bits impl; kernel 2, blockwise.cu, under blockwise);
// this kernel starts from its planes and outcome.  Under bits and watched
// it runs in the reduced plane space; under blockwise, pallas and gather
// in the full space (activation variables set true, AtMost activity from
// card_act), every fixpoint a blockwise sweep over compact rows
// (Planes::tile_rows), the dense rounds, or the watched arm or gather
// rounds of watched.cuh (Planes::arm).  It then runs
// the guess search of core.search (core.py:1143-1391): a circular choice
// deque of (choice row, candidate index) pairs, a guess stack, one plane
// snapshot and Test outcome per guess level, and a block-wide DPLL leaf
// (dpll.cuh) whenever the deque empties with the outcome undetermined.
// With a trace buffer (``T`` > 0; the Pallas kernel keeps none, its
// tracing stays on the XLA path, core.py:1225-1233), each of the lane's
// first T backtrack entries writes the guess-variable stack before the
// pop, -1 padded, to its row of the lane's [T][GS] slice; ``tr_n``
// counts every backtrack either way.
//
// Bound on the H100: the search is a chain of dependent propagation
// fixpoints, each a few rounds of a row scan over the problem's rows with
// two or three barriers per round; a problem's time is that latency
// chain, and the batch (one block per problem) is what fills the card.
// Thread 0 runs the control arms' scalar work (deque, guess stack,
// outcomes) out of shared memory and a per-problem global scratch, and
// leaves each arm's plane work to the block: every snapshot store,
// restore and model copy is one coalesced pass over the W words, and the
// Test after a push is folded into the pass that stores its level.  Every
// control loop's condition is read by all threads between barriers.
#include <cuda_runtime.h>

#include "dpll.cuh"

namespace {

using namespace deppy;

// Search control of one problem (shared).  ``op`` is the plane work the
// control arm leaves to the block: none, a push Test (``var`` assumed on
// level ``lv``, its fixpoint to land on ``sidx``), a null guess (level
// ``lv`` copied to ``sidx``), or a pop whose restored outcome is SAT
// (level ``lv`` becomes the model).
struct SearchCtl {
  int head, cnt, gsp, result, done, need_leaf, steps, tr_n;
  int op, lv, var, sidx;
};

enum { kOpNone = 0, kOpPush = 1, kOpNull = 2, kOpPopSat = 3 };

struct SearchScratch {
  uint32_t* snap_t;  // [GS+1][W]
  uint32_t* snap_f;  // [GS+1][W]
  int* out_st;       // [GS+1]
  int* dq_c;         // [DQ]
  int* dq_i;         // [DQ]
  int* g_c;          // [GS]
  int* g_i;
  int* g_v;
  int* g_ch;
  uint32_t* dpll;    // dpll_scratch_words(NV, W)
};

__host__ __device__ inline size_t search_scratch_words(int NC, int NV,
                                                       int W) {
  const size_t L = (size_t)NC + 2;  // GS + 1 levels, GS = DQ = NC + 1
  const size_t Q = (size_t)NC + 1;
  return 2 * L * W + L + 2 * Q + 4 * Q + dpll_scratch_words(NV, W);
}

__device__ SearchScratch carve_search(uint32_t* base, int NC, int W) {
  const size_t L = (size_t)NC + 2;
  const size_t Q = (size_t)NC + 1;
  SearchScratch X;
  X.snap_t = base;
  X.snap_f = base + L * W;
  int* p = reinterpret_cast<int*>(base + 2 * L * W);
  X.out_st = p;
  X.dq_c = p + L;
  X.dq_i = X.dq_c + Q;
  X.g_c = X.dq_i + Q;
  X.g_i = X.g_c + Q;
  X.g_v = X.g_i + Q;
  X.g_ch = X.g_v + Q;
  X.dpll = reinterpret_cast<uint32_t*>(X.g_ch + Q);
  return X;
}

__device__ inline int mod(int x, int m) { return ((x % m) + m) % m; }

// One trace row: the guess stack g_v[0..gsp), then -1 up to GS.  Out of
// line, so the control loop is compiled as without tracing.
__device__ __noinline__ void trace_row(int* row, const int* g_v, int gsp,
                                       int GS) {
  for (int k = 0; k < GS; ++k) row[k] = k < gsp ? g_v[k] : -1;
}

__global__ void __launch_bounds__(kMaxThreads) search_kernel(
    const uint32_t* __restrict__ pos, const uint32_t* __restrict__ neg,
    const uint32_t* __restrict__ mem, const int* __restrict__ card_n,
    const int* __restrict__ card_valid, const int* __restrict__ card_act,
    Planes L, const int* __restrict__ choice_cand,
    const int* __restrict__ var_choices, const uint32_t* __restrict__ t0,
    const uint32_t* __restrict__ f0, const uint32_t* __restrict__ pvb_all,
    const int* __restrict__ outcome0, const int* __restrict__ enabled_in,
    const int* __restrict__ na_in, int budget, uint32_t* scratch,
    size_t scratch_words, int* result_out, int* steps_out, int* trn_out,
    int* tr_stack, int T, uint32_t* assumed_out, uint32_t* mt_out,
    uint32_t* mf_out, int C, int NA, int W, int NC, int Kc, int NV, int Wch,
    ArmArgs A) {
  extern __shared__ uint32_t smem[];
  __shared__ SearchCtl ctl;
  __shared__ DpllCtl dctl;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool lead = tid == 0;
  const int DQ = NC + 1, GS = NC + 1;
  const Work S = carve_work(smem, W, NA);
  uint32_t* assumed = smem + work_words(W, NA);
  uint32_t* m_t = assumed + W;
  uint32_t* m_f = m_t + W;
  uint32_t* leaf_t = m_f + W;
  uint32_t* leaf_f = leaf_t + W;

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
  const int* cand_tab = choice_cand + (size_t)b * NC * Kc;
  const int* vch_tab = var_choices + (size_t)b * NV * Wch;
  const uint32_t* pvb = pvb_all + (size_t)b * W;
  const SearchScratch X = carve_search(scratch + b * scratch_words, NC, W);
  const DpllScratch D = carve_dpll(X.dpll, NV, W);
  const bool enabled = enabled_in[b] != 0;

  // Set-up, across the block.
  const int na = na_in[b];
  for (int i = tid; i < DQ; i += nt) {
    X.dq_c[i] = i < na ? i : 0;
    X.dq_i[i] = 0;
    X.g_c[i] = X.g_i[i] = X.g_v[i] = X.g_ch[i] = 0;
  }
  for (int i = tid; i <= GS; i += nt) X.out_st[i] = i == 0 ? outcome0[b] : 0;
  block_copy(X.snap_t, t0 + (size_t)b * W, W);
  block_copy(X.snap_f, f0 + (size_t)b * W, W);
  for (int w = tid; w < W; w += nt) assumed[w] = m_t[w] = m_f[w] = 0u;
  if (lead) {
    ctl.head = 0;
    ctl.cnt = na;
    ctl.gsp = 0;
    ctl.result = kRunning;
    ctl.done = 0;
    ctl.need_leaf = 0;
    ctl.steps = 1;
    ctl.tr_n = 0;
    ctl.op = kOpNone;
    ctl.lv = ctl.sidx = ctl.var = 0;
  }

  while (true) {  // episodes: drain control arms, then one DPLL leaf
    __syncthreads();
    bool go = enabled && !ctl.done && ctl.steps <= budget;
    __syncthreads();
    if (!go) break;
    while (true) {  // control arms (search.go:158-203)
      __syncthreads();
      go = enabled && !ctl.done && !ctl.need_leaf && ctl.steps <= budget;
      __syncthreads();
      if (!go) break;
      if (lead) {
        ctl.op = kOpNone;
        const int gsp = ctl.gsp;
        const int cnt = ctl.cnt;
        const int result = ctl.result;
        const bool is_leaf = cnt == 0 && result == kRunning;
        const bool is_bt = !is_leaf && result == kUnsat;
        const bool is_done = !is_leaf && !is_bt && cnt == 0;
        if (is_leaf) {
          ctl.need_leaf = 1;
        } else if (is_bt) {
          // The trace row (search.go:172-173), before the pop changes
          // gsp and g_v.  The lead thread writes it alone, as it runs
          // every control arm: at most T rows of GS words a launch.
          if (tr_stack != nullptr && ctl.tr_n < T)
            trace_row(tr_stack + ((size_t)b * T + ctl.tr_n) * GS, X.g_v, gsp,
                      GS);
          // PopGuess (search.go:79-98).
          ctl.tr_n += 1;
          if (gsp == 0) {
            ctl.done = 1;
          } else {
            const int gsp2 = gsp - 1;
            const int gc = X.g_c[gsp2], gi = X.g_i[gsp2];
            const int gv = X.g_v[gsp2], gch = X.g_ch[gsp2];
            const int head = mod(ctl.head - 1, DQ);
            ctl.head = head;
            ctl.cnt = cnt - gch + 1;
            X.dq_c[head] = gc;
            X.dq_i[head] = gi + (gv >= 0 ? 1 : 0);
            if (gv >= 0) {
              assumed[gv >> 5] &= ~(1u << (gv & 31));
              // The popped level's outcome was recorded when it was
              // pushed: restoring it re-Tests for free.
              const int lv = clampi(gsp2, 0, GS);
              ctl.result = X.out_st[lv];
              if (ctl.result == kSat) {
                ctl.op = kOpPopSat;
                ctl.lv = lv;
              }
            }
            ctl.gsp = gsp2;
            ctl.steps += 1;
          }
        } else if (is_done) {
          ctl.done = 1;
        } else {
          // PushGuess (search.go:34-77).
          const int head = ctl.head;
          const int cid = X.dq_c[clampi(head, 0, DQ - 1)];
          const int idx = X.dq_i[clampi(head, 0, DQ - 1)];
          const int head_push = mod(head + 1, DQ);
          const int* cands = cand_tab + (size_t)clampi(cid, 0, NC - 1) * Kc;
          int ncand = 0;
          bool already = false;
          for (int k = 0; k < Kc; ++k) {
            if (cands[k] >= 0) {
              ++ncand;
              already |= get_bit(assumed, cands[k]);
            }
          }
          int var = idx < ncand ? cands[clampi(idx, 0, Kc - 1)] : -1;
          if (already) var = -1;
          int nch = 0;
          if (var >= 0) {
            const int* row = vch_tab + (size_t)var * Wch;
            for (int k = 0; k < Wch; ++k) {
              if (row[k] < 0) continue;
              const int p = mod(head_push + (cnt - 1) + nch, DQ);
              X.dq_c[p] = row[k];
              X.dq_i[p] = 0;
              ++nch;
            }
          }
          ctl.head = head_push;
          ctl.cnt = cnt - 1 + nch;
          const int g = clampi(gsp, 0, GS - 1);
          X.g_c[g] = cid;
          X.g_i[g] = idx;
          X.g_v[g] = var;
          X.g_ch[g] = nch;
          const int sidx = clampi(gsp + 1, 0, GS);
          ctl.lv = clampi(gsp, 0, GS);
          ctl.sidx = sidx;
          if (var >= 0) {
            assumed[var >> 5] |= 1u << (var & 31);
            ctl.op = kOpPush;
            ctl.var = var;
          } else {
            // A null guess copies the level and its outcome.
            ctl.op = kOpNull;
            X.out_st[sidx] = X.out_st[clampi(gsp, 0, GS)];
            ctl.gsp = gsp + 1;
            ctl.steps += 1;
          }
        }
      }
      __syncthreads();
      // The arm's plane work, across the block.
      const int op = ctl.op;
      const uint32_t* lv_t = X.snap_t + (size_t)ctl.lv * W;
      const uint32_t* lv_f = X.snap_f + (size_t)ctl.lv * W;
      uint32_t* sidx_t = X.snap_t + (size_t)ctl.sidx * W;
      uint32_t* sidx_f = X.snap_f + (size_t)ctl.sidx * W;
      if (op == kOpPopSat) {
        block_copy(m_t, lv_t, W);
        block_copy(m_f, lv_f, W);
      } else if (op == kOpNull) {
        block_copy(sidx_t, lv_t, W);
        block_copy(sidx_f, lv_f, W);
      } else if (op == kOpPush) {
        const int var = ctl.var;
        for (int w = tid; w < W; w += nt) {
          S.t[w] = lv_t[w] | (w == (var >> 5) ? 1u << (var & 31) : 0u);
          S.f[w] = lv_f[w];
        }
      }
      // Propagate only the new literal from the level's fixpoint.
      const bool push_test = op == kOpPush;
      const bool conflict = fixpoint(P, S, nullptr, 0, push_test, true);
      if (push_test) {
        // Test (core.py:991-1002) folded into the level's snapshot pass.
        bool un = false;
        for (int w = tid; w < W; w += nt) {
          const uint32_t t = S.t[w], f = S.f[w];
          sidx_t[w] = t;
          sidx_f[w] = f;
          un |= (pvb[w] & ~(t | f)) != 0u;
        }
        const bool any_un = __syncthreads_or(un) != 0;
        const int out = conflict ? kUnsat : (any_un ? kRunning : kSat);
        if (out == kSat) {
          block_copy(m_t, S.t, W);
          block_copy(m_f, S.f, W);
        }
        if (lead) {
          X.out_st[ctl.sidx] = out;
          ctl.result = out;
          ctl.gsp += 1;
          ctl.steps += 1;
        }
      }
    }
    // Leaf: one full DPLL from the current level (search.go:167-169).
    __syncthreads();
    const bool need_leaf = ctl.need_leaf != 0;
    const int lv = clampi(ctl.gsp, 0, GS);
    const int status = block_dpll(P, S, &dctl, D, pvb, X.snap_t + (size_t)lv * W,
                                  X.snap_f + (size_t)lv * W, nullptr, 0,
                                  budget, &ctl.steps, NV, need_leaf, leaf_t,
                                  leaf_f);
    if (need_leaf && status == kSat) {
      block_copy(m_t, leaf_t, W);
      block_copy(m_f, leaf_f, W);
    }
    if (lead) {
      if (need_leaf) ctl.result = status;
      ctl.need_leaf = 0;
    }
  }

  __syncthreads();
  if (lead) {
    result_out[b] = ctl.done ? ctl.result : kRunning;
    steps_out[b] = ctl.steps;
    trn_out[b] = ctl.tr_n;
  }
  block_copy(assumed_out + (size_t)b * W, assumed, W);
  block_copy(mt_out + (size_t)b * W, m_t, W);
  block_copy(mf_out + (size_t)b * W, m_f, W);
}

}  // namespace

extern "C" size_t deppy_search_scratch_words(int NC, int NV, int W) {
  return search_scratch_words(NC, NV, W);
}

// ``card_valid`` (reduced space) or ``card_act`` (full space) is null.
// ``tile_rows`` 0 runs the bits fixpoint on the dense planes; a positive
// count runs the blockwise one on the compact rows ``lits`` [B][C][K] and
// ``mlits`` [B][NA][M] of ``lit_bytes`` bytes each (cuda_blockwise), which
// ``resident`` keeps in shared memory for the whole launch.  ``arm`` (an
// ArmArgs, or null) selects the watched arm or the gather rounds instead,
// at tile_rows 0; the dense planes are not read then and may be null.
// ``tr_stack`` is the [B][T][NC + 1] trace buffer, or null with T = 0; it
// is not part of the scratch.
extern "C" int deppy_search(
    const void* pos, const void* neg, const void* mem, const void* card_n,
    const void* card_valid, const void* card_act, const void* lits,
    const void* mlits, const void* choice_cand, const void* var_choices,
    const void* t0, const void* f0, const void* pvb, const void* outcome0,
    const void* enabled, const void* na, int budget, void* scratch,
    void* result, void* steps, void* tr_n, void* tr_stack, int T,
    void* assumed, void* m_t, void* m_f, int B, int C, int NA, int W, int NC,
    int Kc, int NV, int Wch,
    int K, int M, int lit_bytes, int tile_rows, int resident, int threads,
    const void* arm, void* stream) {
  if (B == 0) return 0;
  if (!launch_ok(C, tile_rows, threads) || T < 0 ||
      (T > 0) != (tr_stack != nullptr))
    return (int)cudaErrorInvalidValue;
  const Planes L = compact_dims(C, NA, W, lits, mlits, K, M, lit_bytes,
                                tile_rows, resident);
  const ArmArgs A = arm_args(arm);
  const size_t smem = arm_smem_bytes(
      kernel_smem_bytes(work_words(W, NA) + 5 * (size_t)W, L), W, NA, A);
  cudaError_t e = cudaFuncSetAttribute(
      search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  search_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pos), static_cast<const uint32_t*>(neg),
      static_cast<const uint32_t*>(mem), static_cast<const int*>(card_n),
      static_cast<const int*>(card_valid), static_cast<const int*>(card_act),
      L, static_cast<const int*>(choice_cand),
      static_cast<const int*>(var_choices), static_cast<const uint32_t*>(t0),
      static_cast<const uint32_t*>(f0), static_cast<const uint32_t*>(pvb),
      static_cast<const int*>(outcome0), static_cast<const int*>(enabled),
      static_cast<const int*>(na), budget, static_cast<uint32_t*>(scratch),
      search_scratch_words(NC, NV, W), static_cast<int*>(result),
      static_cast<int*>(steps), static_cast<int*>(tr_n),
      static_cast<int*>(tr_stack), T, static_cast<uint32_t*>(assumed),
      static_cast<uint32_t*>(m_t), static_cast<uint32_t*>(m_f), C, NA, W, NC,
      Kc, NV, Wch, A);
  return (int)cudaGetLastError();
}
