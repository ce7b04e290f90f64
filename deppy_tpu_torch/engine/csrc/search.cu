// Kernel 3: phase 1, the preference-ordered guess search.
//
// Replaces deppy_tpu/engine/pallas_search.py:_kernel (:300; entry
// batched_search_fused :916, pallas_call :860).  The baseline fixpoint the
// Pallas kernel runs first is kernel 1's launch (bcp.cu) in this port; this
// kernel starts from its planes and outcome.  It then runs the guess search
// of core.search (core.py:1143-1391, T = 0): a circular choice deque of
// (choice row, candidate index) pairs, a guess stack, one plane snapshot and
// Test outcome per guess level, and a block-wide DPLL leaf (dpll.cuh)
// whenever the deque empties with the outcome undetermined.
//
// Bound on the H100: the search is a chain of dependent propagation
// fixpoints, each a few rounds of a row scan over the problem's planes
// with three barriers per round; a problem's time is that latency chain,
// and the batch (one block per problem) is what fills the card.  Thread 0
// runs the control arms out of shared memory and a per-problem global
// scratch (deque, stack, snapshot trails); the block runs every fixpoint.
// Every control loop's condition is read by all threads between barriers.
#include <cuda_runtime.h>

#include "dpll.cuh"

namespace {

using namespace deppy;

// Search control of one problem (shared).
struct SearchCtl {
  int head, cnt, gsp, result, done, need_leaf, steps, tr_n;
  int push_test, sidx;
};

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

__device__ inline bool get_bit(const uint32_t* plane, int var) {
  return (plane[var >> 5] >> (var & 31)) & 1u;
}

__device__ inline int mod(int x, int m) { return ((x % m) + m) % m; }

__global__ void search_kernel(
    const uint32_t* __restrict__ pos, const uint32_t* __restrict__ neg,
    const uint32_t* __restrict__ mem, const int* __restrict__ card_n,
    const int* __restrict__ card_valid, const int* __restrict__ choice_cand,
    const int* __restrict__ var_choices, const uint32_t* __restrict__ t0,
    const uint32_t* __restrict__ f0, const uint32_t* __restrict__ pvb_all,
    const int* __restrict__ outcome0, const int* __restrict__ enabled_in,
    const int* __restrict__ na_in, int budget, uint32_t* scratch,
    size_t scratch_words, int* result_out, int* steps_out, int* trn_out,
    uint32_t* assumed_out, uint32_t* mt_out, uint32_t* mf_out, int C, int NA,
    int W, int NC, int Kc, int NV, int Wch) {
  extern __shared__ uint32_t smem[];
  __shared__ SearchCtl ctl;
  __shared__ DpllCtl dctl;
  const int b = blockIdx.x;
  const bool lead = threadIdx.x == 0;
  const int DQ = NC + 1, GS = NC + 1;
  const Work S = carve_work(smem, W, NA);
  uint32_t* assumed = smem + work_words(W, NA);
  uint32_t* m_t = assumed + W;
  uint32_t* m_f = m_t + W;
  uint32_t* leaf_t = m_f + W;
  uint32_t* leaf_f = leaf_t + W;

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
  const int* cand_tab = choice_cand + (size_t)b * NC * Kc;
  const int* vch_tab = var_choices + (size_t)b * NV * Wch;
  const uint32_t* pvb = pvb_all + (size_t)b * W;
  const SearchScratch X = carve_search(scratch + b * scratch_words, NC, W);
  const DpllScratch D = carve_dpll(X.dpll, NV, W);
  const bool enabled = enabled_in[b] != 0;

  if (lead) {
    const int na = na_in[b];
    for (int i = 0; i < DQ; ++i) {
      X.dq_c[i] = i < na ? i : 0;
      X.dq_i[i] = 0;
      X.g_c[i] = X.g_i[i] = X.g_v[i] = X.g_ch[i] = 0;
    }
    for (int i = 0; i <= GS; ++i) X.out_st[i] = 0;
    copy_words(X.snap_t, t0 + (size_t)b * W, W);
    copy_words(X.snap_f, f0 + (size_t)b * W, W);
    X.out_st[0] = outcome0[b];
    for (int w = 0; w < W; ++w) assumed[w] = m_t[w] = m_f[w] = 0u;
    ctl.head = 0;
    ctl.cnt = na;
    ctl.gsp = 0;
    ctl.result = kRunning;
    ctl.done = 0;
    ctl.need_leaf = 0;
    ctl.steps = 1;
    ctl.tr_n = 0;
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
        ctl.push_test = 0;
        const int gsp = ctl.gsp;
        const int cnt = ctl.cnt;
        const int result = ctl.result;
        const bool is_leaf = cnt == 0 && result == kRunning;
        const bool is_bt = !is_leaf && result == kUnsat;
        const bool is_done = !is_leaf && !is_bt && cnt == 0;
        const uint32_t* cur_t = X.snap_t + (size_t)clampi(gsp, 0, GS) * W;
        const uint32_t* cur_f = X.snap_f + (size_t)clampi(gsp, 0, GS) * W;
        if (is_leaf) {
          ctl.need_leaf = 1;
        } else if (is_bt) {
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
                copy_words(m_t, X.snap_t + (size_t)lv * W, W);
                copy_words(m_f, X.snap_f + (size_t)lv * W, W);
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
          if (var >= 0) {
            assumed[var >> 5] |= 1u << (var & 31);
            copy_words(S.t, cur_t, W);
            copy_words(S.f, cur_f, W);
            S.t[var >> 5] |= 1u << (var & 31);
            ctl.push_test = 1;
            ctl.sidx = sidx;
          } else {
            // A null guess copies the level and its outcome.
            copy_words(X.snap_t + (size_t)sidx * W, cur_t, W);
            copy_words(X.snap_f + (size_t)sidx * W, cur_f, W);
            X.out_st[sidx] = X.out_st[clampi(gsp, 0, GS)];
            ctl.gsp = gsp + 1;
            ctl.steps += 1;
          }
        }
      }
      __syncthreads();
      const bool push_test = ctl.push_test != 0;
      // Propagate only the new literal from the level's fixpoint.
      const bool conflict = block_fixpoint(P, S, nullptr, 0, push_test, true);
      if (lead && push_test) {
        const int out = test_outcome(conflict, S.t, S.f, pvb, W);
        const int sidx = ctl.sidx;
        copy_words(X.snap_t + (size_t)sidx * W, S.t, W);
        copy_words(X.snap_f + (size_t)sidx * W, S.f, W);
        X.out_st[sidx] = out;
        ctl.result = out;
        if (out == kSat) {
          copy_words(m_t, S.t, W);
          copy_words(m_f, S.f, W);
        }
        ctl.gsp += 1;
        ctl.steps += 1;
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
    if (lead) {
      if (need_leaf) {
        ctl.result = status;
        if (status == kSat) {
          copy_words(m_t, leaf_t, W);
          copy_words(m_f, leaf_f, W);
        }
      }
      ctl.need_leaf = 0;
    }
  }

  if (lead) {
    result_out[b] = ctl.done ? ctl.result : kRunning;
    steps_out[b] = ctl.steps;
    trn_out[b] = ctl.tr_n;
    copy_words(assumed_out + (size_t)b * W, assumed, W);
    copy_words(mt_out + (size_t)b * W, m_t, W);
    copy_words(mf_out + (size_t)b * W, m_f, W);
  }
}

}  // namespace

extern "C" size_t deppy_search_scratch_words(int NC, int NV, int W) {
  return search_scratch_words(NC, NV, W);
}

extern "C" int deppy_search(const void* pos, const void* neg, const void* mem,
                            const void* card_n, const void* card_valid,
                            const void* choice_cand, const void* var_choices,
                            const void* t0, const void* f0, const void* pvb,
                            const void* outcome0, const void* enabled,
                            const void* na, int budget, void* scratch,
                            void* result, void* steps, void* tr_n,
                            void* assumed, void* m_t, void* m_f, int B, int C,
                            int NA, int W, int NC, int Kc, int NV, int Wch,
                            int threads, void* stream) {
  if (B == 0) return 0;
  const size_t smem = (work_words(W, NA) + 5 * (size_t)W) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  search_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pos), static_cast<const uint32_t*>(neg),
      static_cast<const uint32_t*>(mem), static_cast<const int*>(card_n),
      static_cast<const int*>(card_valid),
      static_cast<const int*>(choice_cand),
      static_cast<const int*>(var_choices), static_cast<const uint32_t*>(t0),
      static_cast<const uint32_t*>(f0), static_cast<const uint32_t*>(pvb),
      static_cast<const int*>(outcome0), static_cast<const int*>(enabled),
      static_cast<const int*>(na), budget, static_cast<uint32_t*>(scratch),
      search_scratch_words(NC, NV, W), static_cast<int*>(result),
      static_cast<int*>(steps), static_cast<int*>(tr_n),
      static_cast<uint32_t*>(assumed), static_cast<uint32_t*>(m_t),
      static_cast<uint32_t*>(m_f), C, NA, W, NC, Kc, NV, Wch);
  return (int)cudaGetLastError();
}
