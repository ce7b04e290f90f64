// The round kernel of a clause-sharded solve: one BCP round over one
// clause shard's rows.
//
// No pallas_call site: its counterpart is the reference's XLA round,
// deppy_tpu/engine/core.py:361 round_planes under clause_axis, run on one
// shard's rows up to the input of the fused OR all-gather
// (_axis_or_fused, core.py:343-358).  The output is that buffer, int32
// [2W+1]: wpos | wneg | row_conflict.
//
// * wpos / wneg: the unit literal of every unit clause row of the shard;
//   wneg also holds the members forced false by the shard's full AtMost
//   rows and, when the extras bound is met (popcount(min_bits & t) ==
//   min_w), min_bits & ~a.  That part is replicated over the shards, and
//   the exchange's OR is idempotent on it, so block 0 of every shard
//   adds it.
// * row_conflict: a dead clause row or an over-full active AtMost row.
//
// The replicated tail (min_over, wpos & wneg, the new planes) runs on the
// host after the exchange (core._round_tail_u).
//
// Design.  Unlike kernels 1-5, which run whole phases one problem a
// block, this kernel has one round's row work on a grid of blocks over
// the shard's rows: a shard of the giant catalog is 2,048 clause rows of
// 768 words.  Every block stages t and f in shared memory, one warp
// takes a row at a time (lanes stride over its words; the row's flags
// and counts are warp votes and reductions), a unit row ORs its one
// unassigned literal, and a full AtMost row its unassigned members, into
// the block's shared accumulators, and each block ORs its accumulators
// into the global buffer with one atomicOr per nonzero word.  The launch
// function zeroes the buffer first.  Words are uint32_t, so every shift
// and count is logical, as in fixpoint.cuh; the row loop is this file's
// own, so kernels 1-5 compile as before.
//
// Bound on the H100: the shard's planes are read once (pos, neg, mem and
// the two assignment planes), and a round does ~12 32-bit operations a
// clause word and ~7 an AtMost word: bytes over 3.35 TB/s against
// operations over 67 T/s, bytes the larger at every shape the clause
// path gives it.  One launch a round and slot is latency-bound at these
// sizes (tens of blocks on 132 SMs); merging the slots of one card into
// one launch, or the rounds into a cooperative kernel, is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr size_t kMaxSmemBytes = 232448;

__global__ void __launch_bounds__(kThreads)
shard_round_kernel(const uint32_t* __restrict__ pos,
                   const uint32_t* __restrict__ neg,
                   const uint32_t* __restrict__ mem,
                   const int* __restrict__ act,
                   const int* __restrict__ card_n,
                   const uint32_t* __restrict__ min_bits,
                   const uint32_t* __restrict__ t_in,
                   const uint32_t* __restrict__ f_in, int min_w, int C,
                   int NA, int W, uint32_t* out) {
  extern __shared__ uint32_t smem[];
  uint32_t* t = smem;
  uint32_t* f = smem + W;
  uint32_t* acc_pos = smem + 2 * W;
  uint32_t* acc_neg = smem + 3 * W;
  __shared__ int conflict;
  __shared__ int mtrues;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    t[w] = t_in[w];
    f[w] = f_in[w];
    acc_pos[w] = 0;
    acc_neg[w] = 0;
  }
  if (threadIdx.x == 0) {
    conflict = 0;
    mtrues = 0;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5) * kRowsPerWarp;
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int r = first + k;  // warp-uniform
    if (r >= C + NA) break;
    if (r < C) {
      const uint32_t* p = pos + (size_t)r * W;
      const uint32_t* n = neg + (size_t)r * W;
      bool valid = false, sat = false;
      int un = 0;
      for (int w = lane; w < W; w += 32) {
        const uint32_t pw = p[w], nw = n[w];
        const uint32_t a = t[w] | f[w];
        valid |= (pw | nw) != 0u;
        sat |= ((pw & t[w]) | (nw & f[w])) != 0u;
        un += __popc(pw & ~a) + __popc(nw & ~a);
      }
      valid = __any_sync(kFull, valid);
      sat = __any_sync(kFull, sat);
      un = __reduce_add_sync(kFull, un);
      if (!valid || sat || un > 1) continue;
      if (un == 0) {
        if (lane == 0) conflict = 1;
        continue;
      }
      // A unit row: its one unassigned literal.
      for (int w = lane; w < W; w += 32) {
        const uint32_t a = t[w] | f[w];
        const uint32_t up = p[w] & ~a, uq = n[w] & ~a;
        if (up) atomicOr(&acc_pos[w], up);
        if (uq) atomicOr(&acc_neg[w], uq);
      }
    } else {
      const int j = r - C;
      if (act[j] == 0) continue;
      const uint32_t* m = mem + (size_t)j * W;
      int trues = 0, unk = 0;
      for (int w = lane; w < W; w += 32) {
        const uint32_t mw = m[w];
        trues += __popc(mw & t[w]);
        unk += __popc(mw & ~(t[w] | f[w]));
      }
      trues = __reduce_add_sync(kFull, trues);
      unk = __reduce_add_sync(kFull, unk);
      if (trues > card_n[j]) {
        if (lane == 0) conflict = 1;
      } else if (trues == card_n[j] && unk > 0) {
        // A full row: its unassigned members are forced false.
        for (int w = lane; w < W; w += 32) {
          const uint32_t x = m[w] & ~(t[w] | f[w]);
          if (x) atomicOr(&acc_neg[w], x);
        }
      }
    }
  }

  // The extras bound over the round's entry state, in block 0.
  if (blockIdx.x == 0) {
    int c = 0;
    for (int w = threadIdx.x; w < W; w += blockDim.x)
      c += __popc(min_bits[w] & t[w]);
    if (c) atomicAdd(&mtrues, c);
  }
  __syncthreads();
  const bool bound = blockIdx.x == 0 && mtrues == min_w;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    uint32_t neg_w = acc_neg[w];
    if (bound) neg_w |= min_bits[w] & ~(t[w] | f[w]);
    if (acc_pos[w]) atomicOr(&out[w], acc_pos[w]);
    if (neg_w) atomicOr(&out[W + w], neg_w);
  }
  if (threadIdx.x == 0 && conflict) atomicOr(&out[2 * W], 1u);
}

}  // namespace

// One round over one shard.  int32 inputs: pos/neg [C][W], mem [NA][W],
// act/card_n [NA], min_bits/t/f [W]; out int32 [2W+1], zeroed here on
// the stream before the launch.  C or NA may be 0.
extern "C" int deppy_shard_round(const void* pos, const void* neg,
                                 const void* mem, const void* act,
                                 const void* card_n, const void* min_bits,
                                 const void* t, const void* f, int min_w,
                                 int C, int NA, int W, void* out,
                                 void* stream) {
  if (W < 1 || C < 0 || NA < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)4 * W * sizeof(uint32_t);
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      cudaMemsetAsync(out, 0, (size_t)(2 * W + 1) * sizeof(uint32_t), s);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(shard_round_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int rows = C + NA;
  const int blocks = rows > 0 ? (rows + kRowsPerBlock - 1) / kRowsPerBlock : 1;
  shard_round_kernel<<<blocks, kThreads, smem, s>>>(
      static_cast<const uint32_t*>(pos), static_cast<const uint32_t*>(neg),
      static_cast<const uint32_t*>(mem), static_cast<const int*>(act),
      static_cast<const int*>(card_n), static_cast<const uint32_t*>(min_bits),
      static_cast<const uint32_t*>(t), static_cast<const uint32_t*>(f), min_w,
      C, NA, W, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}
