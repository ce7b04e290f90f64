// Block-wide BCP round and fixpoint over packed bitplanes.
//
// Counterpart: deppy_tpu/engine/core.py:361 (round_planes) and
// deppy_tpu/engine/pallas_search.py:153 (_fixpoint), the fixpoint every
// TPU kernel of the resolve path runs.  Every CUDA kernel includes it.
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
//
// The other fixpoints of a block (the blockwise sweeps, blockwise.cuh; the
// watched arm and the gather rounds, watched.cuh) share the Work and the
// Planes; blockwise.cuh ``fixpoint`` dispatches among them.
#pragma once

#include <cstddef>
#include <cstdint>

namespace deppy {

constexpr int kTrue = 1;
constexpr int kFalse = -1;

constexpr int kSat = 1;
constexpr int kUnsat = -1;
constexpr int kRunning = 0;

// The fixpoint a Planes selects besides the bits rounds and the blockwise
// sweeps (tile_rows > 0): the watched arm and the gather rounds
// (watched.cuh).
enum { kArmRounds = 0, kArmWatched = 1, kArmGather = 2 };

// One problem's rows in one plane space.
struct Planes {
  // The bits fixpoint (tile_rows 0) reads dense planes.
  const uint32_t* pos;            // [C][W] positive literals of each clause
  const uint32_t* neg;            // [C][W] negative literals
  const uint32_t* mem;            // [NA][W] AtMost members
  const int* card_n;              // [NA] AtMost bounds
  // Row activity: static per row (card_valid, the reduced space and the
  // standalone kernels), or, in the full space, "the row's activation
  // variable card_act[r] is true in the entry t" (core.py:900-902).
  // Exactly one is non-null.
  const int* card_valid;          // [NA]
  const int* card_act;            // [NA] activation variable, -1 for none
  int C, NA, W;
  // The blockwise fixpoint (tile_rows > 0, blockwise.cuh) reads compact
  // rows instead: ``lits`` [C][K] signed 1-based literals and ``mlits``
  // [NA][M] 1-based AtMost members, each row's distinct entries first and
  // 0 after, in ``lit_bytes`` (2 or 4) bytes each.  ``region`` is the
  // shared memory they are staged in (blockwise.cuh).
  int tile_rows;
  const void* lits;
  const void* mlits;
  int K, M, lit_bytes, resident;
  unsigned char* region;
  // The watched and gather arms (``arm``, set by set_arm): the raw rows
  // ``clauses`` [C][Kr] (signed 1-based, 0 padded) and ``card_ids``
  // [NA][Mr] (0-based, -1 padded); the watched arm's bank, ``occ_pos`` /
  // ``occ_neg`` [Vb][Ob] (the clause rows holding +v / -v, -1 padded) and
  // ``card_occ`` [NVb][Oc] (the AtMost rows of member v), its entry round
  // on the compact rows ``lits`` / ``mlits`` read from device memory
  // (tile_rows 0), and ``red``: its visits drop literals past n_vars.
  int arm;
  const int* clauses;
  const int* card_ids;
  const int* occ_pos;
  const int* occ_neg;
  const int* card_occ;
  int Kr, Mr, Vb, Ob, NVb, Oc, n_vars, red;
};

// The launch-wide arguments of the watched and gather arms
// (cuda_bcp.ArmArgs, whose fields mirror these), lane 0's pointers.  A
// launch function given none passes an ArmArgs of zeros: kArmRounds.
struct ArmArgs {
  const int* clauses;   // [B][C][Kr]
  const int* card_ids;  // [B][NA][Mr]
  const int* n_vars;    // [B]
  const int* occ_pos;   // [B][Vb][Ob]
  const int* occ_neg;   // [B][Vb][Ob]
  const int* card_occ;  // [B][NVb][Oc]
  const void* lits;     // [B][C][K] compact rows of the entry round
  const void* mlits;    // [B][NA][M] compact AtMost members
  int arm, red, Kr, Mr, Vb, Ob, NVb, Oc, K, M, lit_bytes;
};

// The host copy of a launch's ArmArgs: ``*arm``, or zeros for none.
inline ArmArgs arm_args(const void* arm) {
  ArmArgs A{};
  if (arm != nullptr) A = *static_cast<const ArmArgs*>(arm);
  return A;
}

// Row activity from the kernel arguments: one of the two pointers is
// null (the reduced space passes card_valid, the full one card_act).
__device__ inline void set_activity(Planes& P, const int* card_valid,
                                    const int* card_act, int b) {
  P.card_valid =
      card_valid != nullptr ? card_valid + (size_t)b * P.NA : nullptr;
  P.card_act = card_act != nullptr ? card_act + (size_t)b * P.NA : nullptr;
}

__device__ inline bool get_bit(const uint32_t* plane, int var) {
  return (plane[var >> 5] >> (var & 31)) & 1u;
}

// Whether AtMost row ``r`` is active for a fixpoint entered with ``t``.
// An activation variable outside the planes has no bit, as in the dense
// card_act_bits rows of core.derive_planes.
__device__ inline bool row_active(const Planes& P, const uint32_t* t,
                                  int r) {
  if (P.card_act == nullptr) return P.card_valid[r] != 0;
  const int v = P.card_act[r];
  return v >= 0 && v < 32 * P.W && get_bit(t, v);
}

// A block's shared working set.
struct Work {
  uint32_t* t;     // [W] true plane
  uint32_t* f;     // [W] false plane
  uint32_t* wpos;  // [W] literals forced true this round
  uint32_t* wneg;  // [W] literals forced false this round
  int* act;        // [NA] row activity for the current fixpoint
  int* flags;      // [kFlagWords]
};

// The bits fixpoint's round flags, and the blockwise fixpoint's per-round
// conflict, changed and true-extras slots, two of each so that one round
// resets the next one's while its own are read (blockwise.cuh).
enum {
  kFlagPre = 0, kFlagConflict = 1, kFlagChanged = 2,
  kSlotConflict = 3, kSlotChanged = 5, kSlotMinTrues = 7, kFlagWords = 9
};

// Shared words the Work of one block needs (the flags included).
__host__ __device__ inline size_t work_words(int W, int NA) {
  return 4 * (size_t)W + (size_t)NA + kFlagWords;
}

// Shared words ahead of a kernel's region past its own words: the Work
// and five extra planes of the phase kernels, 16-byte aligned
// (cuda_blockwise.tile_offset_words).  The blockwise fixpoint keeps its
// compact rows there (blockwise.cuh), the watched arm its pending planes
// and counters (watched.cuh).
__host__ __device__ inline size_t tile_offset_words(int W, int NA) {
  return (work_words(W, NA) + 5 * (size_t)W + 3) & ~(size_t)3;
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

// Point P (C, NA and W set) at lane b's rows of the watched or gather arm
// and, for the watched arm, at the shared region past the kernel's own
// words; the other impls leave ``arm`` kArmRounds.
__device__ inline void set_arm(Planes& P, const ArmArgs& A, uint32_t* smem,
                               int b) {
  P.arm = A.arm;
  if (A.arm == kArmRounds) return;
  P.clauses = A.clauses + (size_t)b * P.C * A.Kr;
  P.card_ids = A.card_ids + (size_t)b * P.NA * A.Mr;
  P.Kr = A.Kr;
  P.Mr = A.Mr;
  P.n_vars = A.n_vars[b];
  P.red = A.red;
  if (A.arm != kArmWatched) return;
  P.occ_pos = A.occ_pos + (size_t)b * A.Vb * A.Ob;
  P.occ_neg = A.occ_neg + (size_t)b * A.Vb * A.Ob;
  P.card_occ = A.card_occ + (size_t)b * A.NVb * A.Oc;
  P.Vb = A.Vb;
  P.Ob = A.Ob;
  P.NVb = A.NVb;
  P.Oc = A.Oc;
  P.K = A.K;
  P.M = A.M;
  P.lit_bytes = A.lit_bytes;
  P.lits = static_cast<const unsigned char*>(A.lits) +
           (size_t)b * P.C * A.K * A.lit_bytes;
  P.mlits = static_cast<const unsigned char*>(A.mlits) +
            (size_t)b * P.NA * A.M * A.lit_bytes;
  P.region = reinterpret_cast<unsigned char*>(
      smem + tile_offset_words(P.W, P.NA));
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
// right before it and read them right after.
static __device__ bool block_fixpoint(const Planes& P, const Work& S,
                               const uint32_t* min_bits, int min_w, bool run,
                               bool pre_check) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int W = P.W;
  __syncthreads();
  for (int r = tid; r < P.NA; r += nt) S.act[r] = row_active(P, S.t, r);
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

// Block-wide copy of ``W`` words: every thread copies its stride.
__device__ inline void block_copy(uint32_t* dst, const uint32_t* src, int W) {
  for (int w = threadIdx.x; w < W; w += blockDim.x) dst[w] = src[w];
}

// Block-wide minimum of ``v``, returned in every thread.  Every thread
// calls it; ``red`` is 32 shared ints.  Begins and ends with a barrier.
__device__ inline int block_min(int v, int* red) {
  v = __reduce_min_sync(0xffffffffu, v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = red[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) m = red[i] < m ? red[i] : m;
  __syncthreads();
  return m;
}

}  // namespace deppy
