// Blockwise BCP fixpoint: Gauss-Seidel sweeps over tiles of compact clause
// rows in shared memory.
//
// Counterpart: deppy_tpu/engine/pallas_blockwise.py:_kernel (:67), driven
// by _sweep (:110) and bcp_fixpoint (:147-190).  The Pallas kernel walks a
// sequential grid of clause blocks and keeps t/f in VMEM accumulators
// that persist from one grid step to the next.  CUDA blocks run in no
// order, so here ONE thread block owns the problem and the sweep is a loop
// inside it over tiles of P.tile_rows rows; each tile runs its local
// fixpoint, and t/f stay in shared memory across tiles and sweeps.  The
// AtMost rows are active in tile 0 only (:89), the extras row is
// evaluated in every tile, and once a tile conflicts no later tile runs
// (:91).  Sweeps repeat until one changes nothing or conflicts.
//
// Rows.  The fixpoint reads no dense plane: each clause row is its literal
// list and each AtMost row its member list, as cuda_blockwise.compact_rows
// prepares them from ProblemTensors.clauses / card_ids (every distinct
// signed literal once, 0 after; int16 where the planes hold fewer than
// 32,768 variables).  One thread evaluates a row: satisfied when a literal
// is true, unit when exactly one is unassigned, dead when none is.  The
// distinct literals count as the dense popcounts do, a row holding both x
// and ~x included.  The extras row (min_bits) stays one dense row.
//
// Shared memory (P.region, after the Work and the phase kernels' extra
// planes): the AtMost lists, staged once per launch (stage_compact), then
// either every clause row, staged once per launch too (resident), or two
// tile buffers that each sweep refills from L2 with cp.async, the next
// tile loading while the current one runs its local fixpoint (streaming).
// The choice is by measurement (cuda_blockwise.Compact; PERF.md, Findings):
// where one tile holds every row they stay resident, 25% faster than
// re-staging the one tile each sweep; where there are several tiles they
// stream, 3-7% faster on the giant catalog than 160 KiB of resident rows,
// which leave the SM little L1 for the DPLL's snapshot traffic.
//
// Bound on the H100: a round is one pass of the block's threads over the
// tile's rows (K literal loads each, from shared memory) and over the W
// assignment words, with two barriers; a fixpoint costs its rounds, a
// chain, on one SM.  Streaming adds one L2 read of each tile per sweep,
// hidden behind the previous tile's rounds.
#pragma once

#include <climits>

#include "watched.cuh"

namespace deppy {

// Threads a block of any kernel may have (the kernels' launch bounds).
constexpr int kMaxThreads = 1024;

// Whether the launch arguments common to every kernel are ones it takes.
inline bool launch_ok(int C, int tile_rows, int threads) {
  return tile_rows <= C && threads > 0 && threads % 32 == 0 &&
         threads <= kMaxThreads;
}

// Bytes of ``rows`` lists of ``width`` entries, 16-byte aligned.
__host__ __device__ inline size_t list_bytes(int rows, int width,
                                             int lit_bytes) {
  return ((size_t)rows * width * lit_bytes + 15) & ~(size_t)15;
}

// Bytes of the compact-row region: the AtMost lists, then every clause row
// (resident) or two tiles of them (streaming).
__host__ __device__ inline size_t region_bytes(int C, int NA, int K, int M,
                                               int lit_bytes, int tile_rows,
                                               int resident) {
  return list_bytes(NA, M, lit_bytes) +
         (resident ? list_bytes(C, K, lit_bytes)
                   : 2 * list_bytes(tile_rows, K, lit_bytes));
}

// Dynamic shared bytes of a kernel: its own words for the bits fixpoint,
// or the compact-row region past them for the blockwise one.
inline size_t kernel_smem_bytes(size_t own_words, const Planes& P) {
  if (P.tile_rows <= 0) return own_words * sizeof(uint32_t);
  return tile_offset_words(P.W, P.NA) * sizeof(uint32_t) +
         region_bytes(P.C, P.NA, P.K, P.M, P.lit_bytes, P.tile_rows,
                      P.resident);
}

// The launch-wide fields of the compact rows, for kernel_smem_bytes and
// set_compact: lane 0's pointers, no region yet.
inline Planes compact_dims(int C, int NA, int W, const void* lits,
                           const void* mlits, int K, int M, int lit_bytes,
                           int tile_rows, int resident) {
  Planes P{};
  P.C = C;
  P.NA = NA;
  P.W = W;
  P.lits = lits;
  P.mlits = mlits;
  P.K = K;
  P.M = M;
  P.lit_bytes = lit_bytes;
  P.tile_rows = tile_rows;
  P.resident = resident;
  return P;
}

// Point P (C, NA, W and the launch-wide fields of ``L`` set) at lane b's
// compact rows and at the shared region past the kernel's own words.
__device__ inline void set_compact(Planes& P, const Planes& L, uint32_t* smem,
                                   int b) {
  P.tile_rows = L.tile_rows;
  P.K = L.K;
  P.M = L.M;
  P.lit_bytes = L.lit_bytes;
  P.resident = L.resident;
  P.lits = L.lits == nullptr
               ? nullptr
               : static_cast<const unsigned char*>(L.lits) +
                     (size_t)b * P.C * L.K * L.lit_bytes;
  P.mlits = L.mlits == nullptr
                ? nullptr
                : static_cast<const unsigned char*>(L.mlits) +
                      (size_t)b * P.NA * L.M * L.lit_bytes;
  P.region = reinterpret_cast<unsigned char*>(
      smem + tile_offset_words(P.W, P.NA));
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

// Stage the lane's AtMost lists, and every clause row when they are
// resident, into the shared region.  Once per launch, by every thread,
// before the first fixpoint (whose entry barrier publishes them).  List
// bytes are whole words (the wrapper pads int16 rows to an even width).
__device__ inline void stage_compact(const Planes& P) {
  if (P.tile_rows <= 0) return;
  stage_words(reinterpret_cast<uint32_t*>(P.region),
              static_cast<const uint32_t*>(P.mlits),
              (size_t)P.NA * P.M * P.lit_bytes / 4);
  if (P.resident)
    stage_words(reinterpret_cast<uint32_t*>(
                    P.region + list_bytes(P.NA, P.M, P.lit_bytes)),
                static_cast<const uint32_t*>(P.lits),
                (size_t)P.C * P.K * P.lit_bytes / 4);
}

__device__ inline void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ inline void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying ``n`` bytes (whole words) from device memory into shared
// memory (``dst`` 16-byte aligned): every thread issues its share and
// commits one group, so cp_async_wait<1> after the next call waits for
// this one.
__device__ inline void stage_async(unsigned char* dst,
                                   const unsigned char* src, size_t n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  size_t done = 0;
  if ((reinterpret_cast<size_t>(src) & 15) == 0) {
    const size_t n16 = n / 16;
    for (size_t i = tid; i < n16; i += nt) cp_async16(dst + 16 * i, src + 16 * i);
    done = n16 * 16;
  }
  for (size_t i = done / 4 + tid; i < n / 4; i += nt)
    cp_async4(dst + 4 * i, src + 4 * i);
  asm volatile("cp.async.commit_group;\n" ::);
}

// Propagate (S.t, S.f) to a fixpoint by blockwise sweeps over tiles of
// P.tile_rows compact rows with literals of type ``L``.  The contract of
// block_fixpoint: called by every thread of the block with the same
// arguments, returns the same conflict flag in every thread, does zero
// rounds when ``run`` is false, and begins and ends with a barrier.
//
// A round's conflict, changed and true-extras flags live in one of two
// slots by the round's parity: the round clears the other slot for the
// next round while its own is read, so a round takes two barriers.
template <typename L>
static __device__ __noinline__ bool blockwise_sweeps(
    const Planes& P, const Work& S, const uint32_t* min_bits, int min_w,
    bool run, bool pre_check) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int W = P.W;
  const int T = P.tile_rows;
  const int K = P.K;
  const int M = P.M;
  const int ntiles = (P.C + T - 1) / T;
  const bool stream = !P.resident;
  const L* mlist = reinterpret_cast<const L*>(P.region);
  unsigned char* rows_s = P.region + list_bytes(P.NA, M, sizeof(L));
  const size_t tile_bytes = list_bytes(T, K, sizeof(L));
  const unsigned char* glits = static_cast<const unsigned char*>(P.lits);
  int* fl = S.flags;
  __syncthreads();
  // Row activity from the entry state, cleared accumulators and slots,
  // and the entry-overlap check.
  for (int r = tid; r < P.NA; r += nt) S.act[r] = row_active(P, S.t, r);
  for (int w = tid; w < W; w += nt) {
    S.wpos[w] = 0u;
    S.wneg[w] = 0u;
  }
  if (tid < kFlagWords) fl[tid] = 0;
  bool pre_local = false;
  if (run && pre_check)
    for (int w = tid; w < W; w += nt) pre_local |= (S.t[w] & S.f[w]) != 0u;
  const bool pre = __syncthreads_or(pre_local) != 0;
  bool go = run && !pre;
  if (go && stream)
    stage_async(rows_s, glits, (size_t)min(T, P.C) * K * sizeof(L));
  bool conflict = false;
  int k = 0;    // rounds so far: the parity picks the flag slot
  int buf = 0;  // the streaming buffer of the current tile
  while (go) {  // sweeps
    bool sweep_changed = false;
    for (int i = 0; i < ntiles && !conflict; ++i) {  // tiles
      const int lo = i * T;
      const int rows = min(T, P.C - lo);
      const L* tile;
      if (stream) {
        // Prefetch the next tile in sweep order (tile 0 after the last:
        // the next sweep's first) into the buffer the last tile used.
        const int nlo = i + 1 < ntiles ? lo + T : 0;
        stage_async(rows_s + (buf ^ 1) * tile_bytes,
                    glits + (size_t)nlo * K * sizeof(L),
                    (size_t)min(T, P.C - nlo) * K * sizeof(L));
        cp_async_wait<1>();
        __syncthreads();
        tile = reinterpret_cast<const L*>(rows_s + buf * tile_bytes);
        buf ^= 1;
      } else {
        tile = reinterpret_cast<const L*>(rows_s) + (size_t)lo * K;
      }
      bool local = true;
      while (local) {  // the tile's local fixpoint
        const int s = k & 1;
        // The extras bound counts over the round's entry state.
        if (min_bits != nullptr) {
          int part = 0;
          for (int w = tid; w < W; w += nt) part += __popc(min_bits[w] & S.t[w]);
          if (part) atomicAdd(&fl[kSlotMinTrues + s], part);
        }
        // The tile's clause rows: satisfied, unit or dead.
        for (int r = tid; r < rows; r += nt) {
          const L* row = tile + (size_t)r * K;
          int n_un = 0, unit = 0;
          bool sat = false;
          for (int j = 0; j < K; ++j) {
            const int l = row[j];
            if (l == 0) break;
            const int v = (l > 0 ? l : -l) - 1;
            const uint32_t bit = 1u << (v & 31);
            const uint32_t tw = S.t[v >> 5], fw = S.f[v >> 5];
            if ((l > 0 ? tw : fw) & bit) {
              sat = true;
              break;
            }
            if (!((tw | fw) & bit)) {
              ++n_un;
              unit = l;
            }
          }
          if (sat || row[0] == 0) continue;
          if (n_un == 0) {
            fl[kSlotConflict + s] = 1;
          } else if (n_un == 1) {
            const int v = (unit > 0 ? unit : -unit) - 1;
            atomicOr(unit > 0 ? &S.wpos[v >> 5] : &S.wneg[v >> 5],
                     1u << (v & 31));
          }
        }
        // AtMost rows ride tile 0: more than n true members conflicts,
        // exactly n forces every unassigned member false.
        if (lo == 0) {
          for (int r = tid; r < P.NA; r += nt) {
            if (!S.act[r]) continue;
            const L* mr = mlist + (size_t)r * M;
            int trues = 0, unk = 0;
            for (int j = 0; j < M && mr[j] != 0; ++j) {
              const int v = mr[j] - 1;
              const uint32_t bit = 1u << (v & 31);
              trues += (S.t[v >> 5] & bit) != 0u;
              unk += ((S.t[v >> 5] | S.f[v >> 5]) & bit) == 0u;
            }
            const int n = P.card_n[r];
            if (trues > n) {
              fl[kSlotConflict + s] = 1;
            } else if (trues == n && unk > 0) {
              for (int j = 0; j < M && mr[j] != 0; ++j) {
                const int v = mr[j] - 1;
                const uint32_t bit = 1u << (v & 31);
                if (((S.t[v >> 5] | S.f[v >> 5]) & bit) == 0u)
                  atomicOr(&S.wneg[v >> 5], bit);
              }
            }
          }
        }
        __syncthreads();

        // Apply the round, word by word (the new planes are written even
        // on a conflicting round, as the reference's round does), and
        // clear the accumulators and the next round's slot.
        const int mtrues = fl[kSlotMinTrues + s];
        bool c = mtrues > min_w, ch = false;
        for (int w = tid; w < W; w += nt) {
          const uint32_t t = S.t[w], f = S.f[w], a = t | f;
          const uint32_t wp = S.wpos[w];
          uint32_t wn = S.wneg[w];
          if (min_bits != nullptr && mtrues == min_w) wn |= min_bits[w] & ~a;
          c |= (wp & wn) != 0u;
          const uint32_t new_t = t | (wp & ~a), new_f = f | (wn & ~a);
          ch |= new_t != t || new_f != f;
          S.t[w] = new_t;
          S.f[w] = new_f;
          S.wpos[w] = 0u;
          S.wneg[w] = 0u;
        }
        if (c) fl[kSlotConflict + s] = 1;
        if (ch) fl[kSlotChanged + s] = 1;
        if (tid == 0) {
          fl[kSlotConflict + (s ^ 1)] = 0;
          fl[kSlotChanged + (s ^ 1)] = 0;
          fl[kSlotMinTrues + (s ^ 1)] = 0;
        }
        __syncthreads();
        const bool round_conflict = fl[kSlotConflict + s] != 0;
        const bool round_changed = fl[kSlotChanged + s] != 0;
        ++k;
        conflict = round_conflict;
        sweep_changed |= round_changed && !round_conflict;
        local = !round_conflict && round_changed;
      }
    }
    go = !conflict && sweep_changed;
  }
  if (stream) cp_async_wait<0>();
  __syncthreads();
  return conflict || pre;
}

// The fixpoint the planes select: the watched arm or the gather rounds
// (set_arm), blockwise sweeps when a tile is set, else the bits rounds.
static __device__ bool fixpoint(const Planes& P, const Work& S,
                                const uint32_t* min_bits, int min_w, bool run,
                                bool pre_check) {
  if (P.arm == kArmWatched)
    return P.lit_bytes == 2
               ? watched_fixpoint<int16_t>(P, S, min_bits, min_w, run,
                                           pre_check)
               : watched_fixpoint<int32_t>(P, S, min_bits, min_w, run,
                                           pre_check);
  if (P.arm == kArmGather)
    return gather_fixpoint(P, S, min_bits, min_w, run, pre_check);
  if (P.tile_rows > 0)
    return P.lit_bytes == 2
               ? blockwise_sweeps<int16_t>(P, S, min_bits, min_w, run,
                                           pre_check)
               : blockwise_sweeps<int32_t>(P, S, min_bits, min_w, run,
                                           pre_check);
  return block_fixpoint(P, S, min_bits, min_w, run, pre_check);
}

}  // namespace deppy
