// pulse_commit: the write path's commit phase on Hopper.
//
// Replaces the JAX package's ``_commit_phase``
// (src/repro/core/routing.py:407), which is XLA, not Pallas: a four-pass
// stable lexsort of a shard's pool, then a serial ``lax.fori_loop`` that
// applies every staged mutation the shard can commit, one at a time, in the
// canonical (class, slot, id) order.  The order is built before the launch
// in torch ops (``kernels/pulse_commit/kernel.py:commit_order``: one
// ``torch.sort`` of an int64 key per shard, and each shard's count of
// eligible records); this kernel walks it.
//
// Design: one block of one warp per shard, so shards never touch each
// other's rows or heap registers.  The walk is serial across records (a
// later commit may read what an earlier one wrote: racing stores to one
// slot, a FREE then an ALLOC that pops it), and the warp's lanes split each
// row's W <= 64 words.  A shard with no eligible record returns at once.
// What bounds it on this card: neither bytes nor operations but the chain
// of dependent accesses, one record after another (a few hundred ns each);
// its bytes bound is the eligible records and the rows they touch, each
// moved once.
//
// Semantics, exactly ``_commit_phase``'s:
//   * STORE: a masked write; CAS: the same, guarded on the lowest masked
//     word equal to ``expect`` (word 0 when the mask selects none);
//   * FREE: the row zeroed, the old free head in word 0, the slot pushed;
//   * ALLOC: pop the free list, else bump while ``bump < hi``, else FAULT;
//     the row becomes ``where(mask, data, 0)`` and the slot lands in
//     ``scratch[clip(m_tgt, 0, S - 1)]`` (``m_tgt`` is a scratch index
//     there, never bounds-checked against the shard's rows);
//   * every applied record's ``m_op`` is cleared; a shard without
//     PERM_WRITE faults every eligible record and applies nothing;
//   * heap: ``commits += applied`` (CAS misses and exhausted ALLOCs count),
//     ``epoch += applied > 0``.
// The JAX package shifts the int32 mask right arithmetically by the word
// index; XLA fills a shift of 32 or more with the sign, so a mask with bit
// 31 set also selects words 32..W-1.  ``x >> k`` for k >= 32 is undefined
// in C++, hence ``mask >> min(k, 31)``.
//
// The record layout, opcodes and heap registers come from the port's Python
// modules as -D defines (kernels/pulse_commit/kernel.py).

#include <cuda_runtime.h>

#if !defined(PC_F_STATUS) || !defined(PC_F_SCRATCH) || \
    !defined(PC_M_NONE) || !defined(PC_M_STORE) || !defined(PC_M_CAS) ||       \
    !defined(PC_M_ALLOC) || !defined(PC_M_FREE) || !defined(PC_H_FREE) ||      \
    !defined(PC_H_BUMP) || !defined(PC_H_EPOCH) || !defined(PC_H_COMMITS) ||   \
    !defined(PC_HEAP_WORDS) || !defined(PC_STATUS_FAULT) || !defined(PC_NULL) || \
    !defined(PC_PERM_WRITE) || !defined(PC_MAX_WORDS)
#error "pulse_commit.cu is built by kernels/pulse_commit/kernel.py, which passes its layout"
#endif

namespace {

constexpr int kWarp = 32;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// word w of the staged mask, widened by sign past bit 31 as XLA does
__device__ __forceinline__ bool mask_bit(int mask, int w) {
  return (mask >> (w < 31 ? w : 31)) & 1;
}

__global__ void __launch_bounds__(kWarp) commit_kernel(
    int* __restrict__ pools, int* __restrict__ data, int* __restrict__ heap,
    const long long* __restrict__ order, const int* __restrict__ n_eligible,
    const int* __restrict__ bounds, const int* __restrict__ perms, int L, int R,
    int S, int W) {
  const int s = blockIdx.x;
  const int lane = threadIdx.x;
  const int n = n_eligible[s];
  if (n == 0) return;
  const int lo = bounds[s];
  const int hi = bounds[s + 1];
  const int rows = hi - lo;
  const int MB = PC_F_SCRATCH + S;
  int* pool = pools + static_cast<long long>(s) * L * R;
  const long long* ord = order + static_cast<long long>(s) * L;

  if ((perms[s] & PC_PERM_WRITE) != PC_PERM_WRITE) {
    // write revoked: every eligible commit faults, nothing is applied
    for (int i = lane; i < n; i += kWarp) {
      int* rec = pool + ord[i] * R;
      rec[PC_F_STATUS] = PC_STATUS_FAULT;
      rec[MB] = PC_M_NONE;
    }
    return;
  }

  int* h = heap + s * PC_HEAP_WORDS;
  int free_head = h[PC_H_FREE];
  int bump = h[PC_H_BUMP];
  for (int i = 0; i < n; ++i) {
    int* rec = pool + ord[i] * R;
    const int op = rec[MB];
    const int tgt = rec[MB + 1];
    const int mask = rec[MB + 2];
    const int* staged = rec + MB + 4;
    if (op == PC_M_STORE || op == PC_M_CAS) {
      int* row = data + static_cast<long long>(lo + clampi(tgt - lo, 0, rows - 1)) * W;
      bool write = true;
      if (op == PC_M_CAS) {
        // argmax of the mask's words: the lowest selected, or 0 if none is
        const int low = __ffs(mask) - 1;
        const int first = (low >= 0 && low < W) ? low : 0;
        write = row[first] == rec[MB + 3];
        __syncwarp();  // every lane has read the guard before any writes
      }
      if (write) {
        for (int w = lane; w < W; w += kWarp) {
          if (mask_bit(mask, w)) row[w] = staged[w];
        }
      }
    } else if (op == PC_M_FREE) {
      int* row = data + static_cast<long long>(lo + clampi(tgt - lo, 0, rows - 1)) * W;
      for (int w = lane; w < W; w += kWarp) row[w] = w == 0 ? free_head : 0;
      free_head = tgt;
    } else if (op == PC_M_ALLOC) {
      const bool have_free = free_head != PC_NULL;
      const int slot = have_free ? free_head : bump;
      if (have_free || bump < hi) {
        int* row = data + static_cast<long long>(lo + clampi(slot - lo, 0, rows - 1)) * W;
        const int next_free = row[0];
        __syncwarp();  // the link is read before the row is overwritten
        for (int w = lane; w < W; w += kWarp) row[w] = mask_bit(mask, w) ? staged[w] : 0;
        if (have_free) {
          free_head = next_free;
        } else {
          ++bump;
        }
        if (lane == 0) rec[PC_F_SCRATCH + clampi(tgt, 0, S - 1)] = slot;
      } else if (lane == 0) {
        rec[PC_F_STATUS] = PC_STATUS_FAULT;  // the shard is out of rows
      }
    }
    __syncwarp();  // every lane has read the record before it is cleared
    if (lane == 0) rec[MB] = PC_M_NONE;
    __syncwarp();  // this commit's writes are seen by the next
  }
  if (lane == 0) {
    h[PC_H_FREE] = free_head;
    h[PC_H_BUMP] = bump;
    h[PC_H_EPOCH] += 1;
    h[PC_H_COMMITS] += n;
  }
}

}  // namespace

extern "C" int pulse_commit_launch(void* pools, void* data, void* heap, const void* order,
                                   const void* n_eligible, const void* bounds,
                                   const void* perms, int P, int L, int R, int S, int W,
                                   void* stream) {
  if (P <= 0 || L <= 0) return 0;
  if (W <= 0 || W > PC_MAX_WORDS || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  commit_kernel<<<P, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(pools), static_cast<int*>(data), static_cast<int*>(heap),
      static_cast<const long long*>(order), static_cast<const int*>(n_eligible),
      static_cast<const int*>(bounds), static_cast<const int*>(perms), L, R, S, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pulse_commit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
