// The watched arm and the gather rounds: two more fixpoints of a block.
//
// Counterparts: deppy_tpu/engine/clause_bank.py:226 (watched_fixpoint) and
// deppy_tpu/engine/core.py:428 (bcp_round) with :818 (_bcp_gather).  The
// reference runs both as XLA while-loops, not in Pallas; PyTorch has no
// loop that stays on the device, so here each is a __device__ fixpoint
// that every block kernel reaches through blockwise.cuh ``fixpoint`` when
// its Planes select it (set_arm).  Both keep block_fixpoint's contract:
// called by every thread of the block with the same arguments, the same
// conflict flag returned in every thread, zero rounds when ``run`` is
// false, and a barrier at each end.
//
// Watched.  One dense entry round, computed from the compact rows of the
// space (cuda_blockwise.compact_rows; in the reduced space without the
// literals past n_vars, as the reduced planes have them), gives
// round_planes' result without streaming dense planes.  Its new literals
// seed the pending planes, and the AtMost counters ``trues`` and the
// extras count start from the ENTRY state.  Then each trip pops the
// lowest pending variable (a block-wide minimum), and the block's threads
// split the <= Ob rows of occ_neg[v] (v went true) or occ_pos[v] (v went
// false), recompute each from its raw literals against the shared t/f
// (per occurrence, as the reference does) and OR their units into the
// shared accumulators; a true v then adds one to each AtMost row of
// card_occ[v] (once per entry) and to the extras count, and a row at its
// bound forces its unassigned members false.  The trip merges the new
// literals into t/f and the pending planes.  Pop order is the
// reference's, so the planes left on a conflict are too.
//
// Gather.  Jacobi rounds over every raw clause row and AtMost row,
// counting per occurrence, AtMost activity re-read from each round's
// assignment, a variable forced both ways coming out true (core.py:
// 474-480).  On encoded problems (set semantics) it agrees with the bits
// rounds; on hand-made rows with a repeated literal it need not.
//
// Bound on the H100: a watched fixpoint is one pass over the compact rows
// plus, per popped literal, <= Ob rows of Kr raw literals and four block
// barriers (one a block-wide minimum); the gather fixpoint is the bits
// rounds' chain over raw rows.  Both are latency chains on one SM.
#pragma once

#include <climits>

#include "fixpoint.cuh"

namespace deppy {

// The watched arm's shared words past the kernel's own: the pending
// planes, the AtMost counters, the block_min scratch and its control.
enum { kWatchedMtrues = 32, kWatchedSat = 33, kWatchedCtl = 36 };

__host__ __device__ inline size_t watched_words(int W, int NA) {
  return 2 * (size_t)W + (size_t)NA + kWatchedCtl;
}

// Dynamic shared bytes of a block kernel that needs ``bytes`` under the
// other fixpoints: under the watched arm, its words past
// tile_offset_words.
inline size_t arm_smem_bytes(size_t bytes, int W, int NA, const ArmArgs& A) {
  if (A.arm == kArmWatched)
    return (tile_offset_words(W, NA) + watched_words(W, NA)) *
           sizeof(uint32_t);
  return bytes;
}

// One row of compact literals (0 after the last) against t/f: satisfied,
// or its unassigned literals counted, the last one kept in ``unit``.
template <typename L>
__device__ inline bool compact_row(const L* row, int K, const uint32_t* t,
                                   const uint32_t* f, int& n_un, int& unit) {
  n_un = 0;
  for (int j = 0; j < K; ++j) {
    const int l = row[j];
    if (l == 0) break;
    const int v = (l > 0 ? l : -l) - 1;
    const uint32_t bit = 1u << (v & 31);
    const uint32_t tw = t[v >> 5], fw = f[v >> 5];
    if ((l > 0 ? tw : fw) & bit) return true;
    if (!((tw | fw) & bit)) {
      ++n_un;
      unit = l;
    }
  }
  return false;
}

// OR the literal ``l`` into the round's accumulators.
__device__ inline void force_literal(const Work& S, int l) {
  const int v = (l > 0 ? l : -l) - 1;
  atomicOr(l > 0 ? &S.wpos[v >> 5] : &S.wneg[v >> 5], 1u << (v & 31));
}

// The watched fixpoint (clause_bank.py:226-377) on P's bank, with literals
// of type ``L`` in the compact rows.  P.region holds pend_t [W], pend_f
// [W], trues [NA] and the control words.
template <typename L>
static __device__ __noinline__ bool watched_fixpoint(
    const Planes& P, const Work& S, const uint32_t* min_bits, int min_w,
    bool run, bool pre_check) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int W = P.W;
  uint32_t* pend_t = reinterpret_cast<uint32_t*>(P.region);
  uint32_t* pend_f = pend_t + W;
  int* trues = reinterpret_cast<int*>(pend_f + W);
  int* ctl = trues + P.NA;  // [0, 32): block_min scratch
  int* fl = S.flags;
  const L* lits = static_cast<const L*>(P.lits);
  const L* mlits = static_cast<const L*>(P.mlits);
  __syncthreads();
  // Row activity from the entry state, cleared accumulators and flags,
  // the counters from the entry state, and the entry-overlap check.
  for (int r = tid; r < P.NA; r += nt) {
    S.act[r] = row_active(P, S.t, r);
    int n = 0;
    const L* mr = mlits + (size_t)r * P.M;
    for (int j = 0; j < P.M && mr[j] != 0; ++j) n += get_bit(S.t, mr[j] - 1);
    trues[r] = n;
  }
  for (int w = tid; w < W; w += nt) {
    S.wpos[w] = 0u;
    S.wneg[w] = 0u;
    pend_t[w] = S.t[w];  // the entry state, until the entry round
    pend_f[w] = S.f[w];
  }
  if (tid < kFlagWords) fl[tid] = 0;
  if (tid == 0) ctl[kWatchedMtrues] = 0;
  __syncthreads();
  bool pre_local = false;
  int part = 0;
  for (int w = tid; w < W; w += nt) {
    if (run && pre_check) pre_local |= (S.t[w] & S.f[w]) != 0u;
    if (min_bits != nullptr) part += __popc(min_bits[w] & S.t[w]);
  }
  if (part) atomicAdd(&ctl[kWatchedMtrues], part);
  const bool pre = __syncthreads_or(pre_local) != 0;
  if (!run || pre) {
    __syncthreads();
    return pre;
  }

  // The dense entry round (round_planes), on the compact rows.
  for (int c = tid; c < P.C; c += nt) {
    const L* row = lits + (size_t)c * P.K;
    int n_un, unit = 0;
    if (row[0] == 0 || compact_row(row, P.K, S.t, S.f, n_un, unit)) continue;
    if (n_un == 0)
      fl[kFlagConflict] = 1;
    else if (n_un == 1)
      force_literal(S, unit);
  }
  for (int r = tid; r < P.NA; r += nt) {
    if (!S.act[r]) continue;
    const L* mr = mlits + (size_t)r * P.M;
    int unk = 0;
    for (int j = 0; j < P.M && mr[j] != 0; ++j) {
      const int v = mr[j] - 1;
      unk += ((S.t[v >> 5] | S.f[v >> 5]) >> (v & 31) & 1u) == 0u;
    }
    const int n = P.card_n[r];
    if (trues[r] > n) {
      fl[kFlagConflict] = 1;
    } else if (trues[r] == n && unk > 0) {
      for (int j = 0; j < P.M && mr[j] != 0; ++j) {
        const int v = mr[j] - 1;
        const uint32_t bit = 1u << (v & 31);
        if (((S.t[v >> 5] | S.f[v >> 5]) & bit) == 0u)
          atomicOr(&S.wneg[v >> 5], bit);
      }
    }
  }
  __syncthreads();
  {
    const int mtrues = ctl[kWatchedMtrues];
    bool c = mtrues > min_w;
    for (int w = tid; w < W; w += nt) {
      const uint32_t t = S.t[w], f = S.f[w], a = t | f;
      const uint32_t wp = S.wpos[w];
      uint32_t wn = S.wneg[w];
      if (min_bits != nullptr && mtrues == min_w) wn |= min_bits[w] & ~a;
      c |= (wp & wn) != 0u;
      const uint32_t new_t = t | (wp & ~a), new_f = f | (wn & ~a);
      S.t[w] = new_t;
      S.f[w] = new_f;
      pend_t[w] = new_t & ~pend_t[w];
      pend_f[w] = new_f & ~pend_f[w];
      S.wpos[w] = 0u;
      S.wneg[w] = 0u;
    }
    if (c) fl[kFlagConflict] = 1;
  }
  __syncthreads();
  bool conflict = fl[kFlagConflict] != 0;

  // Pops, the lowest pending variable first.
  while (!conflict) {
    int first = INT_MAX;
    for (int w = tid; w < W && first == INT_MAX; w += nt) {
      const uint32_t u = pend_t[w] | pend_f[w];
      if (u) first = w * 32 + __ffs((int)u) - 1;
    }
    const int v = block_min(first, ctl);
    if (v == INT_MAX) break;
    const int wi = v >> 5;
    const uint32_t vbit = 1u << (v & 31);
    const bool is_true = (pend_t[wi] & vbit) != 0u;
    const bool card = is_true && v < P.NVb;

    // The rows of the polarity v's value falsified, from the raw rows.
    const int* rows = (is_true ? P.occ_neg : P.occ_pos) +
                      (size_t)clampi(v, 0, P.Vb - 1) * P.Ob;
    for (int j = tid; j < P.Ob; j += nt) {
      const int c = rows[j];
      if (c < 0) continue;
      const int* row = P.clauses + (size_t)c * P.Kr;
      bool visited = false, sat = false;
      int n_un = 0, unit = 0;
      for (int k = 0; k < P.Kr && !sat; ++k) {
        const int l = row[k];
        const int x = (l > 0 ? l : -l) - 1;
        if (l == 0 || (P.red && x >= P.n_vars)) continue;
        visited = true;
        const uint32_t bit = 1u << (x & 31);
        if ((l > 0 ? S.t[x >> 5] : S.f[x >> 5]) & bit) {
          sat = true;
        } else if (((S.t[x >> 5] | S.f[x >> 5]) & bit) == 0u) {
          if (n_un == 0) unit = l;
          ++n_un;
        }
      }
      if (!visited || sat) continue;
      if (n_un == 0)
        fl[kFlagConflict] = 1;
      else if (n_un == 1)
        force_literal(S, unit);
    }
    const int* crow = P.card_occ + (size_t)clampi(v, 0, P.NVb - 1) * P.Oc;
    if (card)
      for (int j = tid; j < P.Oc; j += nt)
        if (crow[j] >= 0) atomicAdd(&trues[crow[j]], 1);
    __syncthreads();

    // The AtMost rows of a true v, and the extras row.
    if (card) {
      for (int j = tid; j < P.Oc; j += nt) {
        const int r = crow[j];
        if (r < 0 || !S.act[r]) continue;
        const int n = P.card_n[r];
        if (trues[r] > n) {
          fl[kFlagConflict] = 1;
        } else if (trues[r] == n) {
          const L* mr = mlits + (size_t)r * P.M;
          for (int k = 0; k < P.M && mr[k] != 0; ++k) {
            const int x = mr[k] - 1;
            const uint32_t bit = 1u << (x & 31);
            if (((S.t[x >> 5] | S.f[x >> 5]) & bit) == 0u)
              atomicOr(&S.wneg[x >> 5], bit);
          }
        }
      }
    }
    if (tid == 0) {
      const bool in_min =
          is_true && min_bits != nullptr && (min_bits[wi] & vbit) != 0u;
      const int mtrues = ctl[kWatchedMtrues] + (in_min ? 1 : 0);
      ctl[kWatchedMtrues] = mtrues;
      if (in_min && mtrues > min_w) fl[kFlagConflict] = 1;
      ctl[kWatchedSat] = in_min && mtrues == min_w;
    }
    __syncthreads();

    // Merge the trip's literals into t/f and the pending planes.
    const bool saturated = ctl[kWatchedSat] != 0;
    bool overlap = false;
    for (int w = tid; w < W; w += nt) {
      const uint32_t t = S.t[w], f = S.f[w], a = t | f;
      uint32_t wn = S.wneg[w];
      if (saturated) wn |= min_bits[w] & ~a;
      const uint32_t new_t = S.wpos[w] & ~a, new_f = wn & ~a;
      S.t[w] = t | new_t;
      S.f[w] = f | new_f;
      const uint32_t popped = w == wi ? vbit : 0u;
      pend_t[w] = (pend_t[w] & ~popped) | new_t;
      pend_f[w] = (pend_f[w] & ~popped) | new_f;
      overlap |= ((t | new_t) & (f | new_f)) != 0u;
      S.wpos[w] = 0u;
      S.wneg[w] = 0u;
    }
    if (overlap) fl[kFlagConflict] = 1;
    __syncthreads();
    conflict = fl[kFlagConflict] != 0;
  }
  __syncthreads();
  return conflict;
}

// The gather fixpoint (core.py:818-832): rounds of bcp_round over P's raw
// rows until one conflicts or changes nothing.
static __device__ __noinline__ bool gather_fixpoint(
    const Planes& P, const Work& S, const uint32_t* min_bits, int min_w,
    bool run, bool pre_check) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int W = P.W;
  int* fl = S.flags;
  __syncthreads();
  for (int w = tid; w < W; w += nt) {
    S.wpos[w] = 0u;
    S.wneg[w] = 0u;
  }
  bool pre_local = false;
  if (run && pre_check)
    for (int w = tid; w < W; w += nt) pre_local |= (S.t[w] & S.f[w]) != 0u;
  const bool pre = __syncthreads_or(pre_local) != 0;
  bool go = run && !pre;
  bool conflict = false;
  while (go) {
    // Row activity from this round's assignment, and cleared flags.
    for (int r = tid; r < P.NA; r += nt) S.act[r] = row_active(P, S.t, r);
    if (tid == 0) {
      fl[kFlagConflict] = 0;
      fl[kFlagChanged] = 0;
      fl[kSlotMinTrues] = 0;
    }
    __syncthreads();
    int part = 0;
    if (min_bits != nullptr)
      for (int w = tid; w < W; w += nt) part += __popc(min_bits[w] & S.t[w]);
    if (part) atomicAdd(&fl[kSlotMinTrues], part);

    // Clause rows, per occurrence: the first unassigned one of a unit.
    for (int c = tid; c < P.C; c += nt) {
      const int* row = P.clauses + (size_t)c * P.Kr;
      bool valid = false, sat = false;
      int n_un = 0, unit = 0;
      for (int k = 0; k < P.Kr; ++k) {
        const int l = row[k];
        if (l == 0) continue;
        valid = true;
        const int x = (l > 0 ? l : -l) - 1;
        const uint32_t bit = 1u << (x & 31);
        if ((l > 0 ? S.t[x >> 5] : S.f[x >> 5]) & bit) {
          sat = true;
        } else if (((S.t[x >> 5] | S.f[x >> 5]) & bit) == 0u) {
          if (n_un == 0) unit = l;
          ++n_un;
        }
      }
      if (!valid || sat) continue;
      if (n_un == 0)
        fl[kFlagConflict] = 1;
      else if (n_un == 1)
        force_literal(S, unit);
    }

    // AtMost rows, per member occurrence.
    for (int r = tid; r < P.NA; r += nt) {
      if (!S.act[r]) continue;
      const int* mr = P.card_ids + (size_t)r * P.Mr;
      int trues = 0, unk = 0;
      for (int k = 0; k < P.Mr; ++k) {
        const int x = mr[k];
        if (x < 0) continue;
        const uint32_t bit = 1u << (x & 31);
        trues += (S.t[x >> 5] & bit) != 0u;
        unk += ((S.t[x >> 5] | S.f[x >> 5]) & bit) == 0u;
      }
      const int n = P.card_n[r];
      if (trues > n) {
        fl[kFlagConflict] = 1;
      } else if (trues == n && unk > 0) {
        for (int k = 0; k < P.Mr; ++k) {
          const int x = mr[k];
          if (x < 0) continue;
          const uint32_t bit = 1u << (x & 31);
          if (((S.t[x >> 5] | S.f[x >> 5]) & bit) == 0u)
            atomicOr(&S.wneg[x >> 5], bit);
        }
      }
    }
    __syncthreads();

    // Apply the round: a variable forced both ways comes out true.
    const int mtrues = fl[kSlotMinTrues];
    bool c = mtrues > min_w, ch = false;
    for (int w = tid; w < W; w += nt) {
      const uint32_t t = S.t[w], f = S.f[w], a = t | f;
      const uint32_t wp = S.wpos[w];
      uint32_t wn = S.wneg[w];
      if (min_bits != nullptr && mtrues == min_w) wn |= min_bits[w] & ~a;
      c |= (wp & wn) != 0u;
      const uint32_t new_t = t | (wp & ~a), new_f = f | (wn & ~a & ~wp);
      ch |= new_t != t || new_f != f;
      S.t[w] = new_t;
      S.f[w] = new_f;
      S.wpos[w] = 0u;
      S.wneg[w] = 0u;
    }
    if (c) fl[kFlagConflict] = 1;
    if (ch) fl[kFlagChanged] = 1;
    __syncthreads();
    conflict = fl[kFlagConflict] != 0;
    go = !conflict && fl[kFlagChanged] != 0;
    __syncthreads();
  }
  __syncthreads();
  return conflict || pre;
}

}  // namespace deppy
