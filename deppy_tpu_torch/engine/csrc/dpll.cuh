// Block-wide DPLL over packed bitplanes.
//
// Counterpart: deppy_tpu/engine/pallas_search.py:203 (_dpll), with
// _first_unassigned (:186) and the one-hot row/lane/bit helpers (:96-147)
// turned into plain indexed loads and stores.  Included by the search,
// minimize and core kernels.
//
// Thread 0 runs the decision control (first unassigned variable, the
// decision stack, chronological backtracking); the block runs every
// propagation fixpoint together, by the bits rounds or the blockwise
// sweeps the planes select (blockwise.cuh, ``fixpoint``).  Control state
// lives in shared memory (Ctl), the per-level plane snapshots and decision
// arrays in a per-problem slice of a global scratch buffer the wrapper
// allocates, so no problem size is too large for the kernel.  Each loop
// condition is read by every thread between two barriers.
#pragma once

#include "blockwise.cuh"

namespace deppy {

// Decision control of one DPLL call.
struct DpllCtl {
  int status;
  int sp;
  int flip;
  int do_step;
};

// Per-problem global scratch of one DPLL call.
struct DpllScratch {
  uint32_t* snap_t;  // [(NV+1)][W] plane fixpoint after k decisions
  uint32_t* snap_f;
  int* dec_var;      // [NV]
  int* dec_phase;    // [NV]
};

__host__ __device__ inline size_t dpll_scratch_words(int NV, int W) {
  return 2 * (size_t)(NV + 1) * W + 2 * (size_t)NV;
}

__device__ inline DpllScratch carve_dpll(uint32_t* base, int NV, int W) {
  DpllScratch D;
  D.snap_t = base;
  D.snap_f = base + (size_t)(NV + 1) * W;
  D.dec_var = reinterpret_cast<int*>(base + 2 * (size_t)(NV + 1) * W);
  D.dec_phase = D.dec_var + NV;
  return D;
}

// Complete search under the partial assignment (t_init, f_init): false-first
// decisions on the lowest unassigned problem variable (pvb), chronological
// backtracking that flips the deepest decision still on its false phase.
// ``*steps`` (shared, written by thread 0 only) counts decisions against
// ``budget``.  The model planes land in m_t/m_f (shared).  Returns the
// status in every thread; a disabled call runs no decision and returns
// RUNNING.  Level reads and writes never leave [0, NV] — the reference's
// clip — and the levels read are always ones this call wrote.
static __device__ int block_dpll(const Planes& P, const Work& S, DpllCtl* ctl,
                          const DpllScratch& D, const uint32_t* pvb,
                          const uint32_t* t_init, const uint32_t* f_init,
                          const uint32_t* min_bits, int min_w, int budget,
                          int* steps, int NV, bool enabled, uint32_t* m_t,
                          uint32_t* m_f) {
  const int W = P.W;
  const bool lead = threadIdx.x == 0;
  __syncthreads();
  if (lead) {
    copy_words(S.t, t_init, W);
    copy_words(S.f, f_init, W);
  }
  const bool conflict0 = fixpoint(P, S, min_bits, min_w, enabled, true);
  if (lead) {
    copy_words(D.snap_t, S.t, W);
    copy_words(D.snap_f, S.f, W);
    copy_words(m_t, S.t, W);
    copy_words(m_f, S.f, W);
    ctl->status = conflict0 ? kUnsat : kRunning;
    ctl->sp = 0;
    ctl->flip = 0;
  }
  int status;
  while (true) {
    __syncthreads();
    status = ctl->status;
    const bool go = enabled && status == kRunning && *steps <= budget;
    __syncthreads();
    if (!go) break;
    if (lead) {
      const int sp = ctl->sp;
      const uint32_t* st = D.snap_t + (size_t)clampi(sp, 0, NV) * W;
      const uint32_t* sf = D.snap_f + (size_t)clampi(sp, 0, NV) * W;
      bool has_un = false;
      int first_un = 0;
      for (int w = 0; w < W; ++w) {
        const uint32_t u = pvb[w] & ~(st[w] | sf[w]);
        if (u) {
          has_un = true;
          first_un = w * 32 + __ffs((int)u) - 1;
          break;
        }
      }
      ctl->do_step = 0;
      if (!ctl->flip && !has_un) {
        ctl->status = kSat;
        copy_words(m_t, st, W);
        copy_words(m_f, sf, W);
      } else {
        const int l = clampi(sp, 0, NV - 1);
        copy_words(S.t, st, W);
        copy_words(S.f, sf, W);
        if (ctl->flip) {
          const int var = D.dec_var[l];
          D.dec_phase[l] = kTrue;
          S.t[var >> 5] |= 1u << (var & 31);
        } else {
          D.dec_var[l] = first_un;
          D.dec_phase[l] = kFalse;
          S.f[first_un >> 5] |= 1u << (first_un & 31);
        }
        ctl->do_step = 1;
      }
    }
    __syncthreads();
    const bool do_step = ctl->do_step != 0;
    const bool conflict = fixpoint(P, S, min_bits, min_w, do_step, true);
    if (lead && do_step) {
      *steps += 1;
      const int sp = ctl->sp;
      if (!conflict) {
        const int nxt = clampi(sp + 1, 0, NV);
        copy_words(D.snap_t + (size_t)nxt * W, S.t, W);
        copy_words(D.snap_f + (size_t)nxt * W, S.f, W);
        bool total = true;
        for (int w = 0; w < W; ++w)
          if (pvb[w] & ~(S.t[w] | S.f[w])) total = false;
        if (total) {
          ctl->status = kSat;
          copy_words(m_t, S.t, W);
          copy_words(m_f, S.f, W);
        }
        ctl->sp = sp + 1;
        ctl->flip = 0;
      } else {
        int bt = -1;
        for (int l = sp < NV - 1 ? sp : NV - 1; l >= 0; --l) {
          if (D.dec_phase[l] == kFalse) {
            bt = l;
            break;
          }
        }
        if (bt < 0) {
          ctl->status = kUnsat;
        } else {
          ctl->sp = bt;
          ctl->flip = 1;
        }
      }
    }
  }
  return status;
}

}  // namespace deppy
