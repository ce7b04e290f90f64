// A clause-sharded BCP fixpoint over the whole grid of one card, and the
// row work of one round that it shares with the per-card round kernel.
//
// Counterpart: deppy_tpu/engine/core.py:861-966 (planes_fixpoint's dense
// rounds) under clause_axis, round_planes (core.py:361-421) on every
// shard and the fused OR all-gather (_axis_or_fused, core.py:343-358)
// between its row part and its replicated tail.  Included by
// shard_round.cu; a phase kernel that runs its fixpoints over a card's
// shards calls grid_fixpoint from a cooperative launch of its own.
//
// A Card names the resident shards (slots) of one card through a table in
// global memory, built once a solve, so a card takes any number of slots.
// The rows of all its slots are walked as one concatenated range: a warp takes a row, its
// lanes stride over the row's words (16 bytes a lane when VEC is 4), and
// the row's flags and counts are warp votes and reductions.  A unit row
// ORs its one unassigned literal, a full AtMost row its unassigned
// members, into the block's shared accumulators; a dead or over-full row
// sets the block's conflict.  Each block then ORs its accumulators into a
// global exchange buffer, [2W+1] words (wpos | wneg | row conflict), with
// one atomicOr per nonzero word.
//
// The exchange buffers are three, used in turn: the round that reads
// buffer k has block 0 zero buffer k+1 (mod 3), which the round before
// last read before everyone passed the last barrier.  So one grid barrier
// a round suffices, no memset is needed, and a caller that starts its
// next launch at buffer k + rounds finds it zero.  Buffers are read after
// the barrier with __ldcg (L2, never a stale L1 line).
//
// Words are uint32_t, so every shift and count is logical, as in
// fixpoint.cuh.
#pragma once

#include <cooperative_groups.h>
#include <cstddef>
#include <cstdint>

namespace deppy_grid {

constexpr unsigned kFull = 0xffffffffu;

// One slot's resident shard in one plane space.
struct Slot {
  const uint32_t* pos;  // [C][W] positive literals of each clause row
  const uint32_t* neg;  // [C][W] negative literals
  const uint32_t* mem;  // [NA][W] AtMost members
  const int* card_n;    // [NA] AtMost bounds
  // Row activity: static (card_valid, the reduced space), or, in the full
  // space, "the row's activation variable card_act[j] is true in the
  // fixpoint's entry t" (core.py:900-902).  Exactly one is non-null.
  const int* card_valid;  // [NA]
  const int* card_act;    // [NA] activation variable, -1 for none
  int C, NA;
};

// The n slots of one card, a table in global memory (deppy_card_table):
// rows first[s] .. first[s+1]-1 of the card's concatenated range are slot
// s's (its C clause rows, then its NA AtMost rows).
struct Card {
  const Slot* slot;  // [n]
  const int* first;  // [n+1]
  int n, W;
};

// The slot that holds a row of the card's range (row < first[n]): the
// last s with first[s] <= row, by bisection (warp-uniform loads).
__device__ __forceinline__ int slot_of(const Card& K, int row) {
  int lo = 0, hi = K.n;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(K.first + mid) <= row)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

// Words of each shared array: W rounded up to a multiple of 4, so every
// array starts 16-byte aligned.
__host__ __device__ inline int padded_words(int W) { return (W + 3) & ~3; }

// Shared memory of a block: t, f, min_bits, acc_pos, acc_neg.
__host__ __device__ inline size_t smem_bytes(int W) {
  return (size_t)5 * padded_words(W) * sizeof(uint32_t);
}

template <int VEC>
__device__ __forceinline__ void load_global(const uint32_t* p, int q,
                                            uint32_t (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + q);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = __ldg(p + q);
  }
}

template <int VEC>
__device__ __forceinline__ void load_shared(const uint32_t* s, int q,
                                            uint32_t (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const uint4 v = reinterpret_cast<const uint4*>(s)[q];
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = s[q];
  }
}

// One row's part of a round, by one warp (row is warp-uniform).
template <int VEC>
__device__ void row_part(const Card& K, int row, const uint32_t* t,
                         const uint32_t* f,
                         const uint32_t* __restrict__ t_entry,
                         uint32_t* acc_pos, uint32_t* acc_neg,
                         int* conflict) {
  const int lane = threadIdx.x & 31;
  const int W = K.W;
  const int Q = W / VEC;
  const int s = slot_of(K, row);
  const Slot& S = K.slot[s];
  const int r = row - __ldg(K.first + s);
  if (r < S.C) {
    const uint32_t* p = S.pos + (size_t)r * W;
    const uint32_t* n = S.neg + (size_t)r * W;
    bool valid = false, sat = false;
    int un = 0;
    for (int q = lane; q < Q; q += 32) {
      uint32_t pw[VEC], nw[VEC], tw[VEC], fw[VEC];
      load_global<VEC>(p, q, pw);
      load_global<VEC>(n, q, nw);
      load_shared<VEC>(t, q, tw);
      load_shared<VEC>(f, q, fw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const uint32_t a = tw[i] | fw[i];
        valid |= (pw[i] | nw[i]) != 0u;
        sat |= ((pw[i] & tw[i]) | (nw[i] & fw[i])) != 0u;
        un += __popc(pw[i] & ~a) + __popc(nw[i] & ~a);
      }
    }
    valid = __any_sync(kFull, valid);
    sat = __any_sync(kFull, sat);
    un = __reduce_add_sync(kFull, un);
    if (!valid || sat || un > 1) return;
    if (un == 0) {
      if (lane == 0) *conflict = 1;
      return;
    }
    // A unit row: its one unassigned literal.
    for (int w = lane; w < W; w += 32) {
      const uint32_t a = t[w] | f[w];
      const uint32_t up = __ldg(p + w) & ~a, uq = __ldg(n + w) & ~a;
      if (up) atomicOr(&acc_pos[w], up);
      if (uq) atomicOr(&acc_neg[w], uq);
    }
    return;
  }
  const int j = r - S.C;
  bool active;
  if (S.card_act != nullptr) {
    const int v = S.card_act[j];
    active = v >= 0 && ((__ldg(t_entry + (v >> 5)) >> (v & 31)) & 1u);
  } else {
    active = S.card_valid[j] != 0;
  }
  if (!active) return;
  const uint32_t* m = S.mem + (size_t)j * W;
  int trues = 0, unk = 0;
  for (int q = lane; q < Q; q += 32) {
    uint32_t mw[VEC], tw[VEC], fw[VEC];
    load_global<VEC>(m, q, mw);
    load_shared<VEC>(t, q, tw);
    load_shared<VEC>(f, q, fw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      trues += __popc(mw[i] & tw[i]);
      unk += __popc(mw[i] & ~(tw[i] | fw[i]));
    }
  }
  trues = __reduce_add_sync(kFull, trues);
  unk = __reduce_add_sync(kFull, unk);
  const int bound = S.card_n[j];
  if (trues > bound) {
    if (lane == 0) *conflict = 1;
  } else if (trues == bound && unk > 0) {
    // A full row: its unassigned members are forced false.
    for (int w = lane; w < W; w += 32) {
      const uint32_t x = __ldg(m + w) & ~(t[w] | f[w]);
      if (x) atomicOr(&acc_neg[w], x);
    }
  }
}

// This block's rows of a round: rows blockIdx.x * warps + warp, strided
// by the grid's warps.
template <int VEC>
__device__ void rows_part(const Card& K, const uint32_t* t,
                          const uint32_t* f, const uint32_t* t_entry,
                          uint32_t* acc_pos, uint32_t* acc_neg,
                          int* conflict) {
  const int warps = blockDim.x >> 5;
  const int total = __ldg(K.first + K.n);
  for (int row = blockIdx.x * warps + (threadIdx.x >> 5); row < total;
       row += gridDim.x * warps)
    row_part<VEC>(K, row, t, f, t_entry, acc_pos, acc_neg, conflict);
}

// ORs the block's accumulators and conflict into exchange buffer X.
__device__ inline void flush(uint32_t* X, const uint32_t* acc_pos,
                             const uint32_t* acc_neg, int conflict, int W) {
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    if (acc_pos[w]) atomicOr(&X[w], acc_pos[w]);
    if (acc_neg[w]) atomicOr(&X[W + w], acc_neg[w]);
  }
  if (threadIdx.x == 0 && conflict) atomicOr(&X[2 * W], 1u);
}

// Zeroes words [0, n) of X, by the block.
__device__ inline void zero_words(uint32_t* X, int n) {
  for (int w = threadIdx.x; w < n; w += blockDim.x) X[w] = 0u;
}

// popcount(min_bits & t) over the block's shared words, into *mtrues
// (zeroed by the caller before the last __syncthreads).
__device__ inline void count_extras(const uint32_t* mb, const uint32_t* t,
                                    int W, int* mtrues) {
  int c = 0;
  for (int w = threadIdx.x; w < W; w += blockDim.x) c += __popc(mb[w] & t[w]);
  if (c) atomicAdd(mtrues, c);
}

// The fixpoint over every row of the card, run by every block of a
// cooperative grid.  t, f, mb (min_bits), acc_pos and acc_neg are the
// block's shared arrays, t/f/mb filled with the entry state; t_entry is
// the entry t in global memory (AtMost-row activity), xbuf the three
// exchange buffers, [3][2W+1], and base the buffer the first round uses
// (zero on entry).  Each round: the block's rows into its accumulators,
// the accumulators into the exchange buffer, one grid barrier, then every
// block runs the replicated tail (core.py:416-421) itself from the
// combined buffer: min_over, wpos & wneg, the extras bound's min_bits &
// ~a, the new t and f, changed.  Every block ends a round with the same
// state, so all leave the loop in the same round.  Returns the conflict
// flag and sets *rounds; t and f hold the exit state.
template <int VEC>
__device__ bool grid_fixpoint(const Card& K, uint32_t* t, uint32_t* f,
                              const uint32_t* mb, uint32_t* acc_pos,
                              uint32_t* acc_neg,
                              const uint32_t* __restrict__ t_entry,
                              int min_w, uint32_t* xbuf, int base,
                              int* rounds) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  __shared__ int conflict, mtrues;
  const int W = K.W;
  const int stride = 2 * W + 1;
  int round = 0;
  bool conflicted = false;
  for (;;) {
    uint32_t* X = xbuf + (size_t)((base + round) % 3) * stride;
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      acc_pos[w] = 0u;
      acc_neg[w] = 0u;
    }
    if (threadIdx.x == 0) {
      conflict = 0;
      mtrues = 0;
    }
    if (blockIdx.x == 0)
      zero_words(xbuf + (size_t)((base + round + 1) % 3) * stride, stride);
    __syncthreads();
    rows_part<VEC>(K, t, f, t_entry, acc_pos, acc_neg, &conflict);
    count_extras(mb, t, W, &mtrues);
    __syncthreads();
    flush(X, acc_pos, acc_neg, conflict, W);
    grid.sync();

    // The replicated tail, every block on its own copy.
    const bool bound = mtrues == min_w;
    const bool row_or_over = mtrues > min_w || __ldcg(X + 2 * W) != 0u;
    int clash = 0, moved = 0;
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      const uint32_t a = t[w] | f[w];
      const uint32_t wp = __ldcg(X + w);
      uint32_t wn = __ldcg(X + W + w);
      if (bound) wn |= mb[w] & ~a;
      clash |= (wp & wn) != 0u;
      const uint32_t nt = t[w] | (wp & ~a), nf = f[w] | (wn & ~a);
      moved |= (nt != t[w]) | (nf != f[w]);
      t[w] = nt;
      f[w] = nf;
    }
    conflicted = __syncthreads_or(clash) || row_or_over;
    const bool changed = __syncthreads_or(moved) && !conflicted;
    ++round;
    if (!changed) break;
  }
  *rounds = round;
  return conflicted;
}

}  // namespace deppy_grid
