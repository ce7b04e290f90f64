// Warp-per-problem BCP fixpoint and DPLL over packed bitplanes.
//
// Counterpart: the same functions as fixpoint.cuh's block_fixpoint and
// dpll.cuh's block_dpll (deppy_tpu/engine/core.py:361 round_planes,
// deppy_tpu/engine/pallas_search.py:153 _fixpoint and :203 _dpll), for the
// warp team of kernels 1, 4 and 5 (bcp.cu bcp_warp_kernel, minimize.cu
// minimize_warp_kernel, core.cu core_warp_kernel): one warp owns one
// problem, several problems share a thread block, and no block barrier is
// taken.
//
// Why.  On the bits path these kernels run problems of W = 2-16 plane
// words and 64-256 clause rows, latency-bound on one SM: their time is
// probes x decisions x rounds, each round of the block fixpoint four block
// barriers, shared atomics and clause planes re-read from L1/L2.  With one
// warp a problem, a round keeps its data in registers and its only
// synchronisation is the warp's own shuffles and reductions.
//
// Layout.  Each warp has its own slice of the block's dynamic shared
// memory (warp_work_words, then the kernel's own words, then the DPLL
// snapshots where they fit the per-problem budget; cuda_search.team):
// the problem's pos/neg clause planes and AtMost member planes, staged
// once per launch as they lie in device memory ([C][W], [NA][W]: one
// contiguous 16-byte cp.async stream, where a transposed layout costs a
// 4-byte copy a word, with bank conflicts), the AtMost bounds, the
// activity source (card_valid or card_act) and the row activity of the
// current fixpoint.  A lane reads a row's words with 16- or 8-byte loads
// where W allows (load_row).  Lane w holds assignment words t[w] and f[w], the
// extras row's word and every other per-word plane of the kernel in
// registers (W <= 32); lanes >= W hold zeros.  A round:
//
// * every lane reads the round's entry state, all W words, from its
//   owners with __shfl_sync;
// * clause and AtMost rows are striped over the lanes (row r on lane
//   r % 32); each lane ORs the literals its rows force into per-word
//   registers;
// * one __reduce_or_sync carries the conflict flag and whether any
//   literal was forced; only then does one __reduce_or_sync per word and
//   polarity hand word w's forced literals to lane w, which applies them,
//   and one more carry the conflict and changed flags.
//
// Past the row activity at its entry, a fixpoint writes no shared word
// and takes no warp barrier.  Control state (status, levels, the top of
// the false-phase stack, steps) is held uniformly by every lane, in
// registers.
//
// Bound on the H100: one warp per SM runs a chain of dependent
// instructions (the shuffles, the row scan, the reductions), so a round
// costs its latency, not its bytes or operations; chip_cycles.py breaks a
// round's cycles down (PERF.md, Findings).
//
// Word bound.  The fixpoint, the DPLL and the kernels are instantiated
// for WMAX, the power of two >= W (1, 2, 4, 8, 16 or 32; warp_words_bound),
// so every loop over words unrolls into registers.
//
// Round semantics are block_fixpoint's: the entry check of a variable set
// both ways, AtMost activity from card_valid or card_act at the fixpoint's
// entry state, the extras bound counted over the round's entry state, the
// new planes written even on a conflicting round.  warp_dpll is
// block_dpll's algorithm with the same step accounting.  A lane's snapshot
// words are read back by that lane only, so a flip's restore needs no
// synchronisation wherever the snapshots live; lane 0 writes the decision
// arrays, and every lane passes a __syncwarp before it reads them.
#pragma once

#include "dpll.cuh"

namespace deppy {

constexpr unsigned kFullMask = 0xffffffffu;

// The opt-in dynamic shared memory of one thread block on the H100
// (cuda_blockwise.SMEM_BYTES); a warp-team block's slices share it.
constexpr int kMaxSmemBytes = 232448;

// Problems (warps) a warp-team block may hold: the kernels' launch bounds,
// which leave each thread up to 255 registers.
constexpr int kMaxWarps = 8;

// Shared words of a warp's slice ahead of the kernel's own words: the
// planes, and the AtMost bounds, activity source and activity.
__host__ __device__ inline size_t warp_work_words(int C, int NA, int W) {
  return (2 * (size_t)C + NA) * W + 3 * (size_t)NA;
}

// The power of two >= W a warp kernel is instantiated for (W <= 32).
inline int warp_words_bound(int W) {
  int b = 1;
  while (b < W) b <<= 1;
  return b;
}

// Bytes of one warp's slice of ``words`` words, 16-byte aligned
// (cuda_search.warp_smem_bytes).
__host__ __device__ inline size_t warp_slice_bytes(size_t words) {
  return (words * sizeof(uint32_t) + 15) & ~(size_t)15;
}

// One problem's rows in its warp's slice.
struct WarpPlanes {
  const uint32_t* pos;     // [C][W] positive literals
  const uint32_t* neg;     // [C][W]
  const uint32_t* mem;     // [NA][W] AtMost members
  const int* card_n;       // [NA] AtMost bounds
  // Row activity as in Planes: card_valid (reduced space) or, when
  // ``by_act``, card_act (full space), staged.
  const int* act_src;      // [NA]
  bool by_act;
  int* act;                // [NA] row activity of the current fixpoint
  int C, NA, W;
};

// Start copying ``n`` words from device memory into the slice: 16 bytes
// a cp.async where both sides are 16-byte aligned, else 4, every lane its
// stride, all in flight together.
__device__ inline void warp_copy_async(uint32_t* dst, const uint32_t* src,
                                       int n, int lane) {
  int done = 0;
  if (((reinterpret_cast<size_t>(dst) | reinterpret_cast<size_t>(src)) &
       15) == 0) {
    const int n4 = n / 4;
    for (int i = lane; i < n4; i += 32) cp_async16(dst + 4 * i, src + 4 * i);
    done = 4 * n4;
  }
  for (int i = done + lane; i < n; i += 32) cp_async4(dst + i, src + i);
}

// Row ``r`` of a [rows][W] plane of the slice into x (words >= W zero):
// 16-byte loads where W is a multiple of 4 (the row and the plane then
// start 16-byte aligned in the slice), 8-byte where it is even, else one
// word at a time.
template <int WMAX>
__device__ __forceinline__ void load_row(const uint32_t* plane, int r, int W,
                                         uint32_t (&x)[WMAX]) {
  const uint32_t* row = plane + (size_t)r * W;
  if constexpr (WMAX >= 4) {
    if (W % 4 == 0) {
#pragma unroll
      for (int q = 0; q < WMAX / 4; ++q) {
        const uint4 v = 4 * q < W ? reinterpret_cast<const uint4*>(row)[q]
                                  : make_uint4(0u, 0u, 0u, 0u);
        x[4 * q] = v.x;
        x[4 * q + 1] = v.y;
        x[4 * q + 2] = v.z;
        x[4 * q + 3] = v.w;
      }
      return;
    }
  }
  if constexpr (WMAX >= 2) {
    if (W % 2 == 0) {
#pragma unroll
      for (int q = 0; q < WMAX / 2; ++q) {
        const uint2 v = 2 * q < W ? reinterpret_cast<const uint2*>(row)[q]
                                  : make_uint2(0u, 0u);
        x[2 * q] = v.x;
        x[2 * q + 1] = v.y;
      }
      return;
    }
  }
#pragma unroll
  for (int w = 0; w < WMAX; ++w) x[w] = w < W ? row[w] : 0u;
}

// Carve lane b's slice and stage its planes and bounds, once per launch,
// by the warp: the copies are asynchronous, waited for and published to
// every lane here.
__device__ inline WarpPlanes warp_stage(
    uint32_t* slice, const uint32_t* pos, const uint32_t* neg,
    const uint32_t* mem, const int* card_n, const int* card_valid,
    const int* card_act, int C, int NA, int W, int b, int lane) {
  uint32_t* spos = slice;
  uint32_t* sneg = spos + (size_t)C * W;
  uint32_t* smem_rows = sneg + (size_t)C * W;
  int* scard_n = reinterpret_cast<int*>(smem_rows + (size_t)NA * W);
  int* sact_src = scard_n + NA;
  warp_copy_async(spos, pos + (size_t)b * C * W, C * W, lane);
  warp_copy_async(sneg, neg + (size_t)b * C * W, C * W, lane);
  warp_copy_async(smem_rows, mem + (size_t)b * NA * W, NA * W, lane);
  const int* act_src = card_act != nullptr ? card_act : card_valid;
  for (int r = lane; r < NA; r += 32) {
    cp_async4(scard_n + r, card_n + (size_t)b * NA + r);
    cp_async4(sact_src + r, act_src + (size_t)b * NA + r);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  cp_async_wait<0>();
  __syncwarp();
  WarpPlanes P;
  P.pos = spos;
  P.neg = sneg;
  P.mem = smem_rows;
  P.card_n = scard_n;
  P.act_src = sact_src;
  P.by_act = card_act != nullptr;
  P.act = sact_src + NA;
  P.C = C;
  P.NA = NA;
  P.W = W;
  return P;
}

// Propagate the lanes' (t, f) to a fixpoint.  Called by every lane of the
// warp with the same arguments.  With BOUNDED, ``mb`` is the lane's word
// of the extras row ("at most ``min_w`` of these are true"); without, no
// such row.  With ``pre_check`` an entry state that sets a variable both
// ways is the conflict; a call with ``run`` false does zero rounds.
// Returns the same conflict flag in every lane.  WMAX >= P.W
// (warp_words_bound).
template <int WMAX, bool BOUNDED>
__device__ __forceinline__ bool warp_fixpoint(const WarpPlanes& P,
                                              uint32_t& t, uint32_t& f,
                                              uint32_t mb, int min_w,
                                              bool run, bool pre_check,
                                              int lane) {
  const int W = P.W;
  const int C = P.C;
  const int NA = P.NA;
  // Row activity from the entry state: row r's activation variable v is
  // bit v & 31 of lane v >> 5's word (v < 32 W <= 1024).
  for (int base = 0; base < NA; base += 32) {
    const int r = base + lane;
    const int v = r < NA ? P.act_src[r] : -1;
    const uint32_t word = __shfl_sync(kFullMask, t, (v >> 5) & 31);
    if (r < NA)
      P.act[r] = P.by_act ? (v >= 0 && v < 32 * W && ((word >> (v & 31)) & 1u))
                          : v != 0;
  }
  const bool pre =
      run && pre_check && __any_sync(kFullMask, (t & f) != 0u);
  bool go = run && !pre;
  bool conflict = false;
  while (go) {
    // The round's entry state, every word in every lane.
    uint32_t tr[WMAX], fr[WMAX], ur[WMAX];  // true, false, unassigned
#pragma unroll
    for (int w = 0; w < WMAX; ++w) {
      tr[w] = __shfl_sync(kFullMask, t, w);
      fr[w] = __shfl_sync(kFullMask, f, w);
      ur[w] = w < W ? ~(tr[w] | fr[w]) : 0u;
    }
    // The extras bound counts over the round's entry state.
    int mtrues = 0;
    if (BOUNDED) mtrues = (int)__reduce_add_sync(kFullMask, __popc(mb & t));
    bool c = BOUNDED && mtrues > min_w;
    uint32_t fp[WMAX], fn[WMAX];  // literals this lane's rows force
#pragma unroll
    for (int w = 0; w < WMAX; ++w) fp[w] = fn[w] = 0u;

    // Clause rows: satisfied, unit (one unassigned literal) or dead.
    for (int r = lane; r < C; r += 32) {
      uint32_t p[WMAX], n[WMAX];
      load_row<WMAX>(P.pos, r, W, p);
      load_row<WMAX>(P.neg, r, W, n);
      uint32_t any = 0u, sat = 0u;
      int n_un = 0;
#pragma unroll
      for (int w = 0; w < WMAX; ++w) {
        any |= p[w] | n[w];
        sat |= (p[w] & tr[w]) | (n[w] & fr[w]);
        n_un += __popc(p[w] & ur[w]) + __popc(n[w] & ur[w]);
      }
      if (any == 0u || sat != 0u) continue;
      if (n_un == 0) {
        c = true;
      } else if (n_un == 1) {
#pragma unroll
        for (int w = 0; w < WMAX; ++w) {
          fp[w] |= p[w] & ur[w];
          fn[w] |= n[w] & ur[w];
        }
      }
    }

    // AtMost rows: more than n true members conflicts; exactly n forces
    // every unassigned member false.
    for (int r = lane; r < NA; r += 32) {
      if (!P.act[r]) continue;
      uint32_t m[WMAX];
      load_row<WMAX>(P.mem, r, W, m);
      int trues = 0, unk = 0;
#pragma unroll
      for (int w = 0; w < WMAX; ++w) {
        trues += __popc(m[w] & tr[w]);
        unk += __popc(m[w] & ur[w]);
      }
      const int n = P.card_n[r];
      if (trues > n) {
        c = true;
      } else if (trues == n && unk > 0) {
#pragma unroll
        for (int w = 0; w < WMAX; ++w) fn[w] |= m[w] & ur[w];
      }
    }

    // Whether any literal is forced: by this lane's rows, or by the
    // extras row on this lane's word.  Most rounds (a fixpoint's last)
    // force none, and then skip the per-word reductions: nothing changes.
    uint32_t forced = 0u;
#pragma unroll
    for (int w = 0; w < WMAX; ++w) forced |= fp[w] | fn[w];
    const bool extra = BOUNDED && mtrues == min_w && (mb & ~(t | f)) != 0u;
    const unsigned pre_flags = __reduce_or_sync(
        kFullMask, (c ? 1u : 0u) | (forced != 0u || extra ? 2u : 0u));
    conflict = (pre_flags & 1u) != 0u;
    go = false;
    if (pre_flags & 2u) {
      // Word w's forced literals to lane w, which applies them.  The new
      // planes are written even on a conflicting round, as the
      // reference's round does.
      uint32_t wp = 0u, wn = 0u;
#pragma unroll
      for (int w = 0; w < WMAX; ++w) {
        if (w < W) {
          const uint32_t xp = __reduce_or_sync(kFullMask, fp[w]);
          const uint32_t xn = __reduce_or_sync(kFullMask, fn[w]);
          if (lane == w) {
            wp = xp;
            wn = xn;
          }
        }
      }
      bool ch = false;
      if (lane < W) {
        const uint32_t a = t | f;
        if (BOUNDED && mtrues == min_w) wn |= mb & ~a;
        c |= (wp & wn) != 0u;
        const uint32_t nt = t | (wp & ~a), nf = f | (wn & ~a);
        ch = nt != t || nf != f;
        t = nt;
        f = nf;
      }
      const unsigned flags =
          __reduce_or_sync(kFullMask, (c ? 1u : 0u) | (ch ? 2u : 0u));
      conflict = (flags & 1u) != 0u;
      go = !conflict && (flags & 2u) != 0u;
    }
  }
  return conflict || pre;
}

// Store the lanes' (t, f) as snapshot level ``lvl`` (each lane its word)
// and return, in every lane, the lowest problem variable (``pvb``) they
// leave unassigned, INT_MAX when they assign all of them.
__device__ inline int warp_store_level(const DpllScratch& D, int lvl,
                                       uint32_t t, uint32_t f, uint32_t pvb,
                                       int W, int lane) {
  if (lane < W) {
    D.snap_t[(size_t)lvl * W + lane] = t;
    D.snap_f[(size_t)lvl * W + lane] = f;
  }
  const uint32_t u = pvb & ~(t | f);
  const int first = u != 0u ? lane * 32 + __ffs((int)u) - 1 : INT_MAX;
  return __reduce_min_sync(kFullMask, first);
}

// block_dpll for one warp: complete search under (t_init, f_init), the
// lanes' words, with false-first decisions on the lowest unassigned
// problem variable (pvb) and chronological backtracking to the deepest
// decision still on its false phase (the false-phase level stack of
// block_dpll, whose top every lane holds in ``ftop``).  ``steps``
// (uniform) counts decisions against ``budget``.  The model lands in
// (m_t, m_f).  Returns the status in every lane; a disabled call runs no
// decision and returns RUNNING.  ``D`` is the warp's snapshots and
// decision arrays, in its slice or in global scratch.  BOUNDED, ``mb``
// and ``min_w`` as for warp_fixpoint.
template <int WMAX, bool BOUNDED>
__device__ __forceinline__ int warp_dpll(
    const WarpPlanes& P, const DpllScratch& D, uint32_t pvb,
    uint32_t t_init, uint32_t f_init, uint32_t mb, int min_w, int budget,
    int& steps, int NV, bool enabled, uint32_t& m_t, uint32_t& m_f,
    int lane) {
  const int W = P.W;
  uint32_t t = t_init, f = f_init;
  const bool conflict0 = warp_fixpoint<WMAX, BOUNDED>(P, t, f, mb, min_w,
                                                      enabled, true, lane);
  m_t = t;
  m_f = f;
  // ``first``: the lowest unassigned variable of the current state, which
  // is the snapshot of level sp whenever ``flip`` is false.
  int first = warp_store_level(D, 0, t, f, pvb, W, lane);
  int status = conflict0 ? kUnsat : kRunning;
  int sp = 0, fsp = 0, ftop = -1;  // ftop: D.fstack[fsp - 1]
  bool flip = false;
  while (enabled && status == kRunning && steps <= budget) {
    if (!flip && first == INT_MAX) {
      m_t = t;
      m_f = f;
      status = kSat;
      continue;
    }
    const int l = clampi(sp, 0, NV - 1);
    int var = first;
    if (flip) {
      __syncwarp();  // lane 0's decision-array writes
      var = D.dec_var[l];
      if (lane < W) {
        const size_t s = (size_t)clampi(sp, 0, NV) * W + lane;
        t = D.snap_t[s];
        f = D.snap_f[s];
      }
    }
    if (lane == (var >> 5)) {
      if (flip)
        t |= 1u << (var & 31);
      else
        f |= 1u << (var & 31);
    }
    // Every entry is <= l and they strictly increase, so at most the top
    // one is >= l (dpll.cuh).  A pop reads the entry below, which no
    // write of this decision touches.
    if (fsp > 0 && ftop >= l) {
      --fsp;
      if (fsp > 0) {
        __syncwarp();
        ftop = D.fstack[fsp - 1];
      } else {
        ftop = -1;
      }
    }
    if (!flip) {
      if (lane == 0) {
        D.dec_var[l] = var;
        D.fstack[fsp] = l;
      }
      ftop = l;
      ++fsp;
    }
    const bool conflict =
        warp_fixpoint<WMAX, BOUNDED>(P, t, f, mb, min_w, true, true, lane);
    steps += 1;
    if (!conflict) {
      first = warp_store_level(D, clampi(sp + 1, 0, NV), t, f, pvb, W, lane);
      if (first == INT_MAX) {
        m_t = t;
        m_f = f;
        status = kSat;
      }
      sp += 1;
      flip = false;
    } else if (fsp == 0) {
      status = kUnsat;
    } else {
      sp = ftop;
      flip = true;
    }
  }
  return status;
}

}  // namespace deppy
