// Blockwise BCP fixpoint: Gauss-Seidel sweeps over shared-memory tiles of
// clause rows.
//
// Counterpart: deppy_tpu/engine/pallas_blockwise.py:_kernel (:67), driven
// by _sweep (:110) and bcp_fixpoint (:147-190).  The Pallas kernel walks a
// sequential grid of clause blocks and keeps t/f in VMEM accumulators
// that persist from one grid step to the next.  CUDA blocks run in no
// order, so here ONE thread block owns the problem and the sweep is a loop
// inside it: stage a tile of clause rows (pos and neg) into shared memory,
// run the tile's local fixpoint from shared memory, move to the next
// tile.  t/f stay in shared memory across tiles and sweeps.  The AtMost
// rows are active in tile 0 only (:89), the extras row is evaluated in
// every tile, and once a tile conflicts no later tile runs (:91).  Sweeps
// repeat until one changes nothing or conflicts.
//
// Bound on the H100: a sweep streams the problem's clause planes (2*C*W
// words) from device memory into one SM, so a fixpoint costs sweeps x
// planes bytes through that SM plus one round per tile at least; the
// batch fills the card with one block per problem.  A row is evaluated by
// a group of up to 32 lanes striding over its words (a warp for wide
// planes), reduced with shuffles, so a tile of a few wide rows still
// keeps the block busy.  Tiles are staged with plain coalesced 16-byte
// loads; cp.async/TMA double-buffering is later speed work.
#pragma once

#include "fixpoint.cuh"

namespace deppy {

// Shared words ahead of the tile: the Work and five extra planes of the
// phase kernels, 16-byte aligned (cuda_blockwise.tile_offset_words).
__host__ __device__ inline size_t tile_offset_words(int W, int NA) {
  return (work_words(W, NA) + 5 * (size_t)W + 3) & ~(size_t)3;
}

// Shared words of a tile of ``tile_rows`` rows of pos and neg.
__host__ __device__ inline size_t tile_words(int tile_rows, int W) {
  return 2 * (size_t)tile_rows * W;
}

// Dynamic shared bytes of a kernel: its own words for the bits path, or
// the tile region past them for the blockwise one.
inline size_t kernel_smem_bytes(size_t own_words, int W, int NA,
                                int tile_rows) {
  if (tile_rows <= 0) return own_words * sizeof(uint32_t);
  return (tile_offset_words(W, NA) + tile_words(tile_rows, W)) *
         sizeof(uint32_t);
}

// Lanes that evaluate one row: the largest power of two <= min(32, W).
__device__ inline int row_group(int W) {
  int g = 1;
  while (g < 32 && 2 * g <= W) g *= 2;
  return g;
}

// OR / sum over the ``g`` aligned lanes of a group.  Every lane of the warp
// must call them (the row loops below give every thread the same trips).
__device__ inline uint32_t group_or(uint32_t x, int g) {
  for (int o = g >> 1; o > 0; o >>= 1) x |= __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ inline int group_add(int x, int g) {
  for (int o = g >> 1; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy ``n`` words from device memory into shared memory, 16 bytes a
// thread where both ends allow it, eight loads in flight per thread.
__device__ inline void stage_words(uint32_t* dst, const uint32_t* src,
                                   size_t n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (((reinterpret_cast<size_t>(src) | reinterpret_cast<size_t>(dst)) & 15) ==
      0) {
    const size_t n4 = n / 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (size_t i = tid; i < n4; i += 8 * (size_t)nt) {
      uint4 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const size_t j = i + (size_t)k * nt;
        if (j < n4) v[k] = s4[j];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const size_t j = i + (size_t)k * nt;
        if (j < n4) d4[j] = v[k];
      }
    }
    for (size_t i = n4 * 4 + tid; i < n; i += nt) dst[i] = src[i];
  } else {
    for (size_t i = tid; i < n; i += nt) dst[i] = src[i];
  }
}

// Propagate (S.t, S.f) to a fixpoint by blockwise sweeps over tiles of
// P.tile_rows clause rows.  The contract of block_fixpoint: called by
// every thread of the block with the same arguments, returns the same
// conflict flag in every thread, does zero rounds when ``run`` is false,
// and begins and ends with a barrier.
static __device__ __noinline__ bool block_fixpoint_blockwise(
    const Planes& P, const Work& S, const uint32_t* min_bits, int min_w,
    bool run, bool pre_check) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int W = P.W;
  const int T = P.tile_rows;
  const int g = row_group(W);
  const int lane = tid % g;
  const int grp = tid / g;
  const int ngrp = nt / g;
  uint32_t* tpos = P.tile;
  uint32_t* tneg = P.tile + (size_t)T * W;
  __syncthreads();
  // Row activity for this fixpoint, from the entry state.
  for (int base = 0; base < P.NA; base += ngrp) {
    const int r = base + grp;
    uint32_t a = 0u;
    if (r < P.NA) {
      if (P.card_act_bits != nullptr) {
        const uint32_t* ab = P.card_act_bits + (size_t)r * W;
        for (int w = lane; w < W; w += g) a |= ab[w] & S.t[w];
      } else if (lane == 0) {
        a = P.card_valid[r] != 0;
      }
    }
    a = group_or(a, g);
    if (r < P.NA && lane == 0) S.act[r] = a != 0u;
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
  while (go) {  // sweeps
    bool sweep_changed = false;
    for (int lo = 0; lo < P.C && !conflict; lo += T) {  // tiles
      const int rows = P.C - lo < T ? P.C - lo : T;
      stage_words(tpos, P.pos + (size_t)lo * W, (size_t)rows * W);
      stage_words(tneg, P.neg + (size_t)lo * W, (size_t)rows * W);
      bool local = true;
      while (local) {  // the tile's local fixpoint
        for (int w = tid; w < W; w += nt) {
          S.wpos[w] = 0u;
          S.wneg[w] = 0u;
        }
        if (tid == 0) {
          S.flags[kFlagConflict] = 0;
          S.flags[kFlagChanged] = 0;
          S.flags[kFlagMinTrues] = 0;
        }
        __syncthreads();  // also publishes a freshly staged tile

        // The extras bound counts over the round's entry state.
        if (min_bits != nullptr) {
          int part = 0;
          for (int w = tid; w < W; w += nt) part += __popc(min_bits[w] & S.t[w]);
          if (part) atomicAdd(&S.flags[kFlagMinTrues], part);
        }

        // The tile's clause rows: satisfied, unit or dead.
        for (int base = 0; base < rows; base += ngrp) {
          const int r = base + grp;
          uint32_t valid = 0u, sat = 0u;
          int n_un = 0;
          if (r < rows) {
            const uint32_t* pr = tpos + (size_t)r * W;
            const uint32_t* nr = tneg + (size_t)r * W;
            for (int w = lane; w < W; w += g) {
              const uint32_t p = pr[w], n = nr[w], t = S.t[w], f = S.f[w];
              const uint32_t a = t | f;
              valid |= p | n;
              sat |= (p & t) | (n & f);
              n_un += __popc(p & ~a) + __popc(n & ~a);
            }
          }
          valid = group_or(valid, g);
          sat = group_or(sat, g);
          n_un = group_add(n_un, g);
          if (r >= rows || valid == 0u || sat != 0u) continue;
          if (n_un == 0) {
            if (lane == 0) S.flags[kFlagConflict] = 1;
          } else if (n_un == 1) {
            const uint32_t* pr = tpos + (size_t)r * W;
            const uint32_t* nr = tneg + (size_t)r * W;
            for (int w = lane; w < W; w += g) {
              const uint32_t a = S.t[w] | S.f[w];
              const uint32_t up = pr[w] & ~a, un = nr[w] & ~a;
              if (up) atomicOr(&S.wpos[w], up);
              if (un) atomicOr(&S.wneg[w], un);
            }
          }
        }

        // AtMost rows ride tile 0: more than n true members conflicts,
        // exactly n forces every unassigned member false.
        if (lo == 0) {
          for (int base = 0; base < P.NA; base += ngrp) {
            const int r = base + grp;
            const bool on = r < P.NA && S.act[r];
            int trues = 0, unk = 0;
            if (on) {
              const uint32_t* mr = P.mem + (size_t)r * W;
              for (int w = lane; w < W; w += g) {
                const uint32_t a = S.t[w] | S.f[w];
                trues += __popc(mr[w] & S.t[w]);
                unk += __popc(mr[w] & ~a);
              }
            }
            trues = group_add(trues, g);
            unk = group_add(unk, g);
            if (!on) continue;
            const int n = P.card_n[r];
            if (trues > n) {
              if (lane == 0) S.flags[kFlagConflict] = 1;
            } else if (trues == n && unk > 0) {
              const uint32_t* mr = P.mem + (size_t)r * W;
              for (int w = lane; w < W; w += g) {
                const uint32_t x = mr[w] & ~(S.t[w] | S.f[w]);
                if (x) atomicOr(&S.wneg[w], x);
              }
            }
          }
        }
        __syncthreads();

        // Apply the round, word by word (the new planes are written even
        // on a conflicting round, as the reference's round does).
        const int mtrues = S.flags[kFlagMinTrues];
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
        const bool round_conflict = S.flags[kFlagConflict] != 0;
        const bool round_changed = S.flags[kFlagChanged] != 0;
        __syncthreads();
        conflict = round_conflict;
        sweep_changed |= round_changed && !round_conflict;
        local = !round_conflict && round_changed;
      }
    }
    go = !conflict && sweep_changed;
  }
  __syncthreads();
  return conflict || pre;
}

// The fixpoint the planes select: blockwise sweeps when a tile is set,
// else the bits rounds.
static __device__ bool fixpoint(const Planes& P, const Work& S,
                                const uint32_t* min_bits, int min_w, bool run,
                                bool pre_check) {
  if (P.tile_rows > 0)
    return block_fixpoint_blockwise(P, S, min_bits, min_w, run, pre_check);
  return block_fixpoint(P, S, min_bits, min_w, run, pre_check);
}

}  // namespace deppy
