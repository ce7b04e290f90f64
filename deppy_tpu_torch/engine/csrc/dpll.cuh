// Block-wide DPLL over packed bitplanes.
//
// Counterpart: deppy_tpu/engine/pallas_search.py:203 (_dpll), with
// _first_unassigned (:186) and the one-hot row/lane/bit helpers (:96-147)
// turned into plain indexed loads and stores.  Included by the search,
// minimize and core kernels.
//
// Thread 0 takes the decisions (the decision variable of a level, the
// stack of levels still on their false phase, the status); the block does
// every pass over the W words of a plane together: the restore of a level
// after a backtrack, the snapshot of each new level, the search for the
// lowest unassigned problem variable (a block-wide minimum) with the
// totality check folded into it, and every propagation fixpoint (the bits
// rounds or the blockwise sweeps the planes select, blockwise.cuh
// ``fixpoint``).  Control state lives in shared memory (DpllCtl), the
// per-level plane snapshots and decision arrays in a per-problem slice of
// a global scratch buffer the wrapper allocates, so no problem size is too
// large for the kernel.  Each loop condition is read by every thread
// between two barriers.
#pragma once

#include "blockwise.cuh"

namespace deppy {

// Decision control of one DPLL call.
struct DpllCtl {
  int status;
  int sp;
  int flip;
  int fsp;       // levels on the false-phase stack
  int red[32];   // block_min scratch
};

// Per-problem global scratch of one DPLL call.
struct DpllScratch {
  uint32_t* snap_t;  // [(NV+1)][W] plane fixpoint after k decisions
  uint32_t* snap_f;
  int* dec_var;      // [NV] decision variable of each level
  int* fstack;       // [NV] levels whose decision is on its false phase
};

__host__ __device__ inline size_t dpll_scratch_words(int NV, int W) {
  return 2 * (size_t)(NV + 1) * W + 2 * (size_t)NV;
}

__device__ inline DpllScratch carve_dpll(uint32_t* base, int NV, int W) {
  DpllScratch D;
  D.snap_t = base;
  D.snap_f = base + (size_t)(NV + 1) * W;
  D.dec_var = reinterpret_cast<int*>(base + 2 * (size_t)(NV + 1) * W);
  D.fstack = D.dec_var + NV;
  return D;
}

// Store (S.t, S.f) as snapshot level ``lvl`` and return, in every thread,
// the lowest problem variable (pvb) they leave unassigned, INT_MAX when
// they assign all of them.  One coalesced pass; begins and ends with a
// barrier (block_min).
__device__ inline int store_level(const Work& S, const DpllScratch& D,
                                  int lvl, const uint32_t* pvb, int W,
                                  int* red) {
  uint32_t* st = D.snap_t + (size_t)lvl * W;
  uint32_t* sf = D.snap_f + (size_t)lvl * W;
  int first = INT_MAX;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const uint32_t t = S.t[w], f = S.f[w];
    st[w] = t;
    sf[w] = f;
    const uint32_t u = pvb[w] & ~(t | f);
    if (u != 0u && first == INT_MAX) first = w * 32 + __ffs((int)u) - 1;
  }
  return block_min(first, red);
}

// Complete search under the partial assignment (t_init, f_init): false-first
// decisions on the lowest unassigned problem variable (pvb), chronological
// backtracking that flips the deepest decision still on its false phase.
// ``*steps`` (shared, written by thread 0 only) counts decisions against
// ``budget``.  The model planes land in m_t/m_f (shared).  Returns the
// status in every thread; a disabled call runs no decision and returns
// RUNNING.  Level reads and writes never leave [0, NV] — the reference's
// clip — and the levels read are always ones this call wrote.
//
// The reference finds the backtrack level by scanning dec_phase from the
// current level down (core.py:1100-1110).  Here thread 0 keeps the levels
// on their false phase as a stack instead: a decision at level l drops the
// entry for l (its old decision is off the current path) and pushes l when
// its phase is false, so the top is the deepest false level <= l, the
// level the scan finds.  The search reaches a level only by deciding every
// level below it, so no stale entry survives below l, and none lies above
// it: a success moves one level up, a backtrack to the top entry.
static __device__ int block_dpll(const Planes& P, const Work& S, DpllCtl* ctl,
                                 const DpllScratch& D, const uint32_t* pvb,
                                 const uint32_t* t_init,
                                 const uint32_t* f_init,
                                 const uint32_t* min_bits, int min_w,
                                 int budget, int* steps, int NV, bool enabled,
                                 uint32_t* m_t, uint32_t* m_f) {
  const int W = P.W;
  const bool lead = threadIdx.x == 0;
  __syncthreads();
  block_copy(S.t, t_init, W);
  block_copy(S.f, f_init, W);
  const bool conflict0 = fixpoint(P, S, min_bits, min_w, enabled, true);
  block_copy(m_t, S.t, W);
  block_copy(m_f, S.f, W);
  // ``first``: the lowest unassigned variable of the current state, which
  // is the snapshot of level sp whenever ``flip`` is 0.
  int first = store_level(S, D, 0, pvb, W, ctl->red);
  if (lead) {
    ctl->status = conflict0 ? kUnsat : kRunning;
    ctl->sp = 0;
    ctl->flip = 0;
    ctl->fsp = 0;
  }
  int status;
  while (true) {
    __syncthreads();
    status = ctl->status;
    const int sp = ctl->sp;
    const bool flip = ctl->flip != 0;
    const bool go = enabled && status == kRunning && *steps <= budget;
    __syncthreads();
    if (!go) break;
    if (!flip && first == INT_MAX) {
      // Every problem variable of level sp is assigned: its planes (the
      // current state) are the model.
      block_copy(m_t, S.t, W);
      block_copy(m_f, S.f, W);
      if (lead) ctl->status = kSat;
      continue;
    }
    // The decision at level l: the deepest false decision flipped true
    // (its level restored from the snapshot), or the lowest unassigned
    // variable set false.
    const int l = clampi(sp, 0, NV - 1);
    const int var = flip ? D.dec_var[l] : first;
    const uint32_t* st = D.snap_t + (size_t)clampi(sp, 0, NV) * W;
    const uint32_t* sf = D.snap_f + (size_t)clampi(sp, 0, NV) * W;
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      uint32_t t = flip ? st[w] : S.t[w];
      uint32_t f = flip ? sf[w] : S.f[w];
      if (w == (var >> 5)) {
        if (flip)
          t |= 1u << (var & 31);
        else
          f |= 1u << (var & 31);
      }
      S.t[w] = t;
      S.f[w] = f;
    }
    if (lead) {
      // Every entry is <= l and they strictly increase, so at most the
      // top one is >= l: level l itself, after a backtrack to it or a
      // decision clipped to NV - 1.
      int fsp = ctl->fsp;
      if (fsp > 0 && D.fstack[fsp - 1] >= l) --fsp;
      if (!flip) {
        D.dec_var[l] = var;
        D.fstack[fsp++] = l;
      }
      ctl->fsp = fsp;
    }
    const bool conflict = fixpoint(P, S, min_bits, min_w, true, true);
    if (!conflict) {
      first = store_level(S, D, clampi(sp + 1, 0, NV), pvb, W, ctl->red);
      if (first == INT_MAX) {
        block_copy(m_t, S.t, W);
        block_copy(m_f, S.f, W);
      }
      if (lead) {
        *steps += 1;
        if (first == INT_MAX) ctl->status = kSat;
        ctl->sp = sp + 1;
        ctl->flip = 0;
      }
    } else if (lead) {
      *steps += 1;
      const int fsp = ctl->fsp;
      if (fsp == 0) {
        ctl->status = kUnsat;
      } else {
        ctl->sp = D.fstack[fsp - 1];
        ctl->flip = 1;
      }
    }
  }
  return status;
}

}  // namespace deppy
