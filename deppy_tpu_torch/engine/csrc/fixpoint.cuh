// Block-wide BCP round and fixpoint over packed bitplanes.
//
// Counterpart: deppy_tpu/engine/core.py:361 (round_planes) and
// deppy_tpu/engine/pallas_search.py:153 (_fixpoint), the fixpoint every
// TPU kernel of the resolve path runs.  All four CUDA kernels include it.
//
// One thread block owns one problem.  The assignment planes (t, f), the
// round's forced-literal accumulators and the AtMost-row activity live in
// shared memory; the clause and AtMost planes are read from device memory
// every round (L1/L2 serve the re-reads).  Within a round the block's
// threads stride over clause rows and AtMost rows and OR their forced
// literals into the shared accumulators with atomicOr; the conflict and
// changed flags are plain stores of 1 into shared memory.  Every loop
// condition is read by all threads between two __syncthreads(), so all
// threads of a block take the same trip count.
//
// Words are handled as uint32_t, so every shift is logical and variable 31
// of a word is just bit 31 (the reference keeps int32 words and logical
// shifts for the same reason).
#pragma once

#include <cstddef>
#include <cstdint>

namespace deppy {

constexpr int kTrue = 1;
constexpr int kFalse = -1;

constexpr int kSat = 1;
constexpr int kUnsat = -1;
constexpr int kRunning = 0;

// One problem's planes in one plane space.
struct Planes {
  const uint32_t* pos;            // [C][W] positive literals of each clause
  const uint32_t* neg;            // [C][W] negative literals
  const uint32_t* mem;            // [NA][W] AtMost members
  const int* card_n;              // [NA] AtMost bounds
  // Row activity: static per row in the reduced space (card_valid), or,
  // in the full space, "the row's activation bit is set in the entry t"
  // (card_act_bits, core.py:900-902).  Exactly one is non-null.
  const int* card_valid;          // [NA]
  const uint32_t* card_act_bits;  // [NA][W]
  int C, NA, W;
};

// A block's shared working set.
struct Work {
  uint32_t* t;     // [W] true plane
  uint32_t* f;     // [W] false plane
  uint32_t* wpos;  // [W] literals forced true this round
  uint32_t* wneg;  // [W] literals forced false this round
  int* act;        // [NA] row activity for the current fixpoint
  int* flags;      // [4]
};

enum { kFlagPre = 0, kFlagConflict = 1, kFlagChanged = 2 };

// Shared words the Work of one block needs (the flags included).
__host__ __device__ inline size_t work_words(int W, int NA) {
  return 4 * (size_t)W + (size_t)NA + 4;
}

__device__ inline Work carve_work(uint32_t* base, int W, int NA) {
  Work S;
  S.t = base;
  S.f = base + W;
  S.wpos = base + 2 * W;
  S.wneg = base + 3 * W;
  S.act = reinterpret_cast<int*>(base + 4 * W);
  S.flags = reinterpret_cast<int*>(base + 4 * W + NA);
  return S;
}

__device__ inline int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Propagate (S.t, S.f) to a fixpoint.  Called by every thread of the block
// with the same arguments; returns the same conflict flag in every thread.
// ``min_bits`` (nullptr = no bound) and ``min_w`` are the dynamic "at most
// min_w of these are true" row of the minimization probes.  With
// ``pre_check`` an entry state that sets a variable both ways is the
// conflict (core.py:877-883); the standalone BCP kernel has no such check
// (pallas_bcp.py:50-76).  A call with ``run`` false does zero rounds.
// The call begins and ends with a barrier, so a caller may write S.t/S.f
// from one thread right before it and read them right after.
static __device__ bool block_fixpoint(const Planes& P, const Work& S,
                               const uint32_t* min_bits, int min_w, bool run,
                               bool pre_check) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int W = P.W;
  __syncthreads();
  for (int r = tid; r < P.NA; r += nt) {
    int a = 0;
    if (P.card_act_bits != nullptr) {
      const uint32_t* ab = P.card_act_bits + (size_t)r * W;
      for (int w = 0; w < W; ++w) a |= (ab[w] & S.t[w]) != 0u;
    } else {
      a = P.card_valid[r] != 0;
    }
    S.act[r] = a;
  }
  if (tid == 0) S.flags[kFlagPre] = 0;
  __syncthreads();
  if (run && pre_check) {
    for (int w = tid; w < W; w += nt)
      if (S.t[w] & S.f[w]) S.flags[kFlagPre] = 1;
  }
  __syncthreads();
  const bool pre = S.flags[kFlagPre] != 0;
  bool go = run && !pre;
  bool conflict = false;
  while (go) {
    for (int w = tid; w < W; w += nt) {
      S.wpos[w] = 0u;
      S.wneg[w] = 0u;
    }
    if (tid == 0) {
      S.flags[kFlagConflict] = 0;
      S.flags[kFlagChanged] = 0;
    }
    __syncthreads();

    // The extras bound counts over the round's entry state.
    int mtrues = 0;
    if (min_bits != nullptr)
      for (int w = 0; w < W; ++w) mtrues += __popc(min_bits[w] & S.t[w]);

    // Clause rows: satisfied, unit (one unassigned literal) or dead.
    for (int c = tid; c < P.C; c += nt) {
      const uint32_t* pr = P.pos + (size_t)c * W;
      const uint32_t* nr = P.neg + (size_t)c * W;
      bool valid = false, sat = false;
      int n_un = 0;
      for (int w = 0; w < W; ++w) {
        const uint32_t p = pr[w], n = nr[w], t = S.t[w], f = S.f[w];
        const uint32_t a = t | f;
        valid |= (p | n) != 0u;
        sat |= ((p & t) | (n & f)) != 0u;
        n_un += __popc(p & ~a) + __popc(n & ~a);
      }
      if (!valid || sat) continue;
      if (n_un == 0) {
        S.flags[kFlagConflict] = 1;
      } else if (n_un == 1) {
        for (int w = 0; w < W; ++w) {
          const uint32_t a = S.t[w] | S.f[w];
          const uint32_t up = pr[w] & ~a, un = nr[w] & ~a;
          if (up) atomicOr(&S.wpos[w], up);
          if (un) atomicOr(&S.wneg[w], un);
        }
      }
    }

    // AtMost rows: more than n true members conflicts; exactly n forces
    // every unassigned member false.
    for (int r = tid; r < P.NA; r += nt) {
      if (!S.act[r]) continue;
      const uint32_t* mr = P.mem + (size_t)r * W;
      int trues = 0, unk = 0;
      for (int w = 0; w < W; ++w) {
        const uint32_t a = S.t[w] | S.f[w];
        trues += __popc(mr[w] & S.t[w]);
        unk += __popc(mr[w] & ~a);
      }
      const int n = P.card_n[r];
      if (trues > n) {
        S.flags[kFlagConflict] = 1;
      } else if (trues == n && unk > 0) {
        for (int w = 0; w < W; ++w) {
          const uint32_t x = mr[w] & ~(S.t[w] | S.f[w]);
          if (x) atomicOr(&S.wneg[w], x);
        }
      }
    }
    __syncthreads();

    // Apply the round, word by word.  The new planes are written even on
    // a conflicting round, as the reference's round does.
    if (tid == 0 && mtrues > min_w) S.flags[kFlagConflict] = 1;
    for (int w = tid; w < W; w += nt) {
      const uint32_t t = S.t[w], f = S.f[w], a = t | f;
      const uint32_t wp = S.wpos[w];
      uint32_t wn = S.wneg[w];
      if (min_bits != nullptr && mtrues == min_w) wn |= min_bits[w] & ~a;
      if (wp & wn) S.flags[kFlagConflict] = 1;
      const uint32_t new_t = t | (wp & ~a), new_f = f | (wn & ~a);
      if (new_t != t || new_f != f) S.flags[kFlagChanged] = 1;
      S.t[w] = new_t;
      S.f[w] = new_f;
    }
    __syncthreads();
    conflict = S.flags[kFlagConflict] != 0;
    go = !conflict && S.flags[kFlagChanged] != 0;
    __syncthreads();
  }
  __syncthreads();
  return conflict || pre;
}

// Outcome of a propagated state (core.py:991-1002): UNSAT on conflict,
// SAT when every problem variable is assigned, else RUNNING.
__device__ inline int test_outcome(bool conflict, const uint32_t* t,
                                   const uint32_t* f, const uint32_t* pvb,
                                   int W) {
  if (conflict) return kUnsat;
  for (int w = 0; w < W; ++w)
    if (pvb[w] & ~(t[w] | f[w])) return kRunning;
  return kSat;
}

__device__ inline void copy_words(uint32_t* dst, const uint32_t* src, int W) {
  for (int w = 0; w < W; ++w) dst[w] = src[w];
}

}  // namespace deppy
