// The clause path's kernels: a clause-sharded BCP fixpoint as one
// cooperative launch a card, and one round over a card's shards for a
// mesh that spans cards or ranks.
//
// No pallas_call site: the counterpart is the reference's XLA rounds,
// deppy_tpu/engine/core.py:361 round_planes under clause_axis inside
// planes_fixpoint (core.py:861-966): each shard's row part, the fused OR
// all-gather (_axis_or_fused, core.py:343-358) and the replicated tail
// (core.py:416-421), every round.
//
// * grid_fixpoint_kernel: the whole fixpoint on one card, every slot of
//   the card in one launch (grid_fixpoint.cuh): the rounds loop inside
//   the kernel, every block holds a share of the rows as every device
//   holds a shard, and global memory and a grid barrier take the place
//   of the all-gather.  Output [2W+2]: conflict, rounds, t, f.
// * card_round_kernel: one round's row part over every slot of the card,
//   folded into one [2W+1] buffer (wpos | wneg | row conflict) that the
//   host folds with the other cards' and ranks' before the tail.  Block 0
//   adds the extras bound's min_bits & ~a once, the part replicated over
//   the shards (OR is idempotent on it).
//
// Both write one of three exchange buffers and zero the next one, so no
// launch has a memset.
//
// Bound on the H100: a fixpoint launch reads the card's planes (pos, neg,
// mem), the bounds, the activity and the state once and writes its
// output once, and does ~12 32-bit operations a clause word, ~7 an
// AtMost word and ~8 an assignment word a round: max(bytes / 3.35 TB/s,
// operations x rounds / 67 T/s), as chip_smoke.py's _bound and _need
// count it; bytes bound it at every shape the clause path gives it.
//
// What held the earlier design back, and what this one does.  It was one
// launch a round and slot, each of a few dozen blocks, with a memset of
// its own, and every round crossed to the host: the state uploaded, each
// slot's buffer copied back and folded, the tail run as torch ops.  Now a
// fixpoint is one launch of as many blocks as the card holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SMs, never more:
// co-residency is what makes the barrier safe), rows are read 16 bytes a
// lane, the exchange is atomics into L2 and one barrier a round, and the
// host reads one small buffer a fixpoint.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "grid_fixpoint.cuh"

namespace {

using deppy_grid::Card;
using deppy_grid::Slot;

constexpr int kThreads = 512;
constexpr size_t kMaxSmemBytes = 232448;

struct Shared {
  uint32_t *t, *f, *mb, *acc_pos, *acc_neg;
};

// The block's shared arrays, t/f/min_bits filled from state rows 0-2 and
// the accumulators zeroed.
__device__ Shared stage(const uint32_t* __restrict__ state, int W) {
  extern __shared__ uint4 smem4[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem4);
  const int Wp = deppy_grid::padded_words(W);
  Shared s{smem, smem + Wp, smem + 2 * Wp, smem + 3 * Wp, smem + 4 * Wp};
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    s.t[w] = state[w];
    s.f[w] = state[W + w];
    s.mb[w] = state[2 * W + w];
    s.acc_pos[w] = 0u;
    s.acc_neg[w] = 0u;
  }
  return s;
}

// state [3][W]: t, f, min_bits (t is the entry t of the rows' activity).
// out [2W+2]: conflict, rounds, t, f.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
grid_fixpoint_kernel(const __grid_constant__ Card K,
                     const uint32_t* __restrict__ state, int min_w,
                     uint32_t* xbuf, int base, uint32_t* out) {
  const int W = K.W;
  Shared s = stage(state, W);
  __syncthreads();
  int rounds = 0;
  const bool conflict = deppy_grid::grid_fixpoint<VEC>(
      K, s.t, s.f, s.mb, s.acc_pos, s.acc_neg, state, min_w, xbuf, base,
      &rounds);
  if (blockIdx.x == 0) {
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      out[2 + w] = s.t[w];
      out[2 + W + w] = s.f[w];
    }
    if (threadIdx.x == 0) {
      out[0] = conflict ? 1u : 0u;
      out[1] = (uint32_t)rounds;
    }
  }
}

// state [4][W]: t, f, min_bits and the fixpoint's entry t (the rows'
// activity).  Writes exchange buffer k, zeroes buffer k+1 (mod 3).
template <int VEC>
__global__ void __launch_bounds__(kThreads)
card_round_kernel(const __grid_constant__ Card K,
                  const uint32_t* __restrict__ state, int min_w,
                  uint32_t* xbuf, int k) {
  __shared__ int conflict, mtrues;
  const int W = K.W;
  const int stride = 2 * W + 1;
  Shared s = stage(state, W);
  if (threadIdx.x == 0) {
    conflict = 0;
    mtrues = 0;
  }
  if (blockIdx.x == 0)
    deppy_grid::zero_words(xbuf + (size_t)((k + 1) % 3) * stride, stride);
  __syncthreads();
  deppy_grid::rows_part<VEC>(K, s.t, s.f, state + 3 * W, s.acc_pos,
                             s.acc_neg, &conflict);
  if (blockIdx.x == 0) deppy_grid::count_extras(s.mb, s.t, W, &mtrues);
  __syncthreads();
  if (blockIdx.x == 0 && mtrues == min_w) {
    // Same thread-to-word map as flush: each thread its own words.
    for (int w = threadIdx.x; w < W; w += blockDim.x)
      s.acc_neg[w] |= s.mb[w] & ~(s.t[w] | s.f[w]);
  }
  deppy_grid::flush(xbuf + (size_t)k * stride, s.acc_pos, s.acc_neg,
                    conflict, W);
}

// The card over the table of n slots at table (deppy_card_table's
// layout: n Slots, then first[n+1]).
int card_from(const void* table, int n, int W, Card* K) {
  if (table == nullptr || n < 1 || W < 1 ||
      reinterpret_cast<uintptr_t>(table) % alignof(Slot))
    return (int)cudaErrorInvalidValue;
  K->slot = static_cast<const Slot*>(table);
  K->first = reinterpret_cast<const int*>(K->slot + n);
  K->n = n;
  K->W = W;
  return 0;
}

template <typename Kernel>
int plan(Kernel kernel, int W, int cooperative, int* blocks) {
  const size_t smem = deppy_grid::smem_bytes(W);
  if (W < 1 || smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (cooperative && !coop) return (int)cudaErrorNotSupported;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  return 0;
}

}  // namespace

// The most blocks of a kernel that fit on the current card at once at
// width W (fixpoint 1: the cooperative fixpoint kernel, 0: the round
// kernel; vec 4 or 1), into *blocks; sets the kernel's shared-memory
// limit where it needs more than 48 KB.  A card without cooperative
// launches refuses the fixpoint kernel (cudaErrorNotSupported), a width
// past the shared memory a block may hold or a grid the occupancy API
// refuses raise as launch defects.
extern "C" int deppy_card_plan(int W, int fixpoint, int vec, void* blocks) {
  int* b = static_cast<int*>(blocks);
  if (vec != 1 && vec != 4) return (int)cudaErrorInvalidValue;
  if (fixpoint)
    return vec == 4 ? plan(grid_fixpoint_kernel<4>, W, 1, b)
                    : plan(grid_fixpoint_kernel<1>, W, 1, b);
  return vec == 4 ? plan(card_round_kernel<4>, W, 0, b)
                  : plan(card_round_kernel<1>, W, 0, b);
}

// Bytes of the slot table of a card of n slots (deppy_card_table).
extern "C" size_t deppy_card_table_bytes(int n) {
  return n < 1 ? 0 : n * sizeof(Slot) + (n + 1) * sizeof(int);
}

// Writes the slot table of a card of n slots into host memory at table
// (deppy_card_table_bytes(n) bytes, 8-byte aligned), for the caller to
// copy to the card once: ptrs holds 6 device pointers a slot (pos, neg,
// mem, card_n, card_valid, card_act; exactly one of the last two null),
// dims 2 ints a slot (C, NA).
extern "C" int deppy_card_table(const void* const* ptrs, const int* dims,
                                int n, void* table) {
  if (n < 1 || table == nullptr ||
      reinterpret_cast<uintptr_t>(table) % alignof(Slot))
    return (int)cudaErrorInvalidValue;
  Slot* slot = static_cast<Slot*>(table);
  int* first = reinterpret_cast<int*>(slot + n);
  first[0] = 0;
  for (int i = 0; i < n; ++i) {
    Slot& s = slot[i];
    s.pos = static_cast<const uint32_t*>(ptrs[6 * i]);
    s.neg = static_cast<const uint32_t*>(ptrs[6 * i + 1]);
    s.mem = static_cast<const uint32_t*>(ptrs[6 * i + 2]);
    s.card_n = static_cast<const int*>(ptrs[6 * i + 3]);
    s.card_valid = static_cast<const int*>(ptrs[6 * i + 4]);
    s.card_act = static_cast<const int*>(ptrs[6 * i + 5]);
    s.C = dims[2 * i];
    s.NA = dims[2 * i + 1];
    if (s.C < 0 || s.NA < 0 ||
        (s.card_valid == nullptr) == (s.card_act == nullptr) ||
        (long long)first[i] + s.C + s.NA > INT32_MAX)
      return (int)cudaErrorInvalidValue;
    first[i + 1] = first[i] + s.C + s.NA;
  }
  return 0;
}

// One clause-sharded fixpoint over the card's n slots (table: their slot
// table, on the card): int32 state [3][W] (t, f, min_bits), xbuf
// [3][2W+1] with buffer k zero, out [2W+2]; blocks from deppy_card_plan.
// vec 4 needs W % 4 == 0 and 16-byte aligned planes.
extern "C" int deppy_grid_fixpoint(const void* table, int n, int W, int vec,
                                   const void* state, int min_w, void* xbuf,
                                   int k, void* out, int blocks,
                                   void* stream) {
  Card K;
  int rc = card_from(table, n, W, &K);
  if (rc) return rc;
  if ((vec != 1 && vec != 4) || (vec == 4 && W % 4) || blocks < 1 || k < 0 ||
      k > 2)
    return (int)cudaErrorInvalidValue;
  const uint32_t* st = static_cast<const uint32_t*>(state);
  uint32_t* xb = static_cast<uint32_t*>(xbuf);
  uint32_t* o = static_cast<uint32_t*>(out);
  void* args[] = {&K, &st, &min_w, &xb, &k, &o};
  const void* fn = vec == 4 ? (const void*)grid_fixpoint_kernel<4>
                            : (const void*)grid_fixpoint_kernel<1>;
  return (int)cudaLaunchCooperativeKernel(
      fn, dim3(blocks), dim3(kThreads), args, deppy_grid::smem_bytes(W),
      static_cast<cudaStream_t>(stream));
}

// One round's row part over the card's n slots (table: their slot table,
// on the card) into exchange buffer k of xbuf [3][2W+1] (zero on entry),
// zeroing buffer k+1: int32 state [4][W] (t, f, min_bits, entry t);
// blocks at most deppy_card_plan's.
extern "C" int deppy_card_round(const void* table, int n, int W, int vec,
                                const void* state, int min_w, void* xbuf,
                                int k, int blocks, void* stream) {
  Card K;
  int rc = card_from(table, n, W, &K);
  if (rc) return rc;
  if ((vec != 1 && vec != 4) || (vec == 4 && W % 4) || blocks < 1 || k < 0 ||
      k > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* st = static_cast<const uint32_t*>(state);
  uint32_t* xb = static_cast<uint32_t*>(xbuf);
  const size_t smem = deppy_grid::smem_bytes(W);
  if (vec == 4)
    card_round_kernel<4><<<blocks, kThreads, smem, s>>>(K, st, min_w, xb, k);
  else
    card_round_kernel<1><<<blocks, kThreads, smem, s>>>(K, st, min_w, xb, k);
  return (int)cudaGetLastError();
}
