// pulse_commit: the write path's commit phase on Hopper.
//
// Replaces the JAX package's ``_commit_phase``
// (src/repro/core/routing.py:407), which is XLA, not Pallas: a four-pass
// stable lexsort of a shard's pool, then a serial ``lax.fori_loop`` that
// applies every staged mutation the shard can commit, one at a time, in the
// canonical (class, slot, id) order.  That order is stricter than the
// semantics: it only has to order (a) the STOREs and CASes to ONE slot, by
// id (a CAS reads what an earlier store wrote), (b) every FREE after every
// STORE/CAS and every ALLOC after every FREE, and (c) the pops of the free
// list, each reading the link the previous pop left.  Stores to distinct
// slots touch distinct rows and need no order among themselves.
//
// So a commit phase is four steps on one stream, with no host read
// (kernels/pulse_commit/kernel.py:launch):
//   1. ``commit_key``, one thread per record of all P x L: eligibility,
//      class (0 STORE/CAS, 1 FREE, 2 ALLOC), slot (0 for an ALLOC), and the
//      int64 key ``(class * cap + slot) * L + id``; ``3 * cap * L`` for a
//      record no shard commits.  Bound by bytes: each record's five header
//      words read, its key written.
//   2. ``torch.sort`` of each shard's keys, values and indices (outside any
//      kernel, as the JAX package leaves its lexsort to XLA).  A shard's
//      class boundaries are the lower bounds of cap*L, 2*cap*L and the top
//      key in its sorted keys, found by binary search where needed.
//   3. ``commit_apply``, a grid of (tiles of kTile sorted positions) x P:
//      a position whose slot differs from its predecessor's heads a
//      same-slot run, and one group of kGroup lanes applies the run's
//      records in order (the CAS guard is the lowest masked word, word 0
//      when the mask selects none; the group syncs between reading the
//      guard and writing the row).  Runs touch disjoint rows, so every run
//      of every shard is applied at once.  On a shard without PERM_WRITE,
//      every eligible record of every class faults instead and nothing is
//      applied.  Bound by bytes (each store's order index, header, masked
//      staged words and written words), in practice by the latency of
//      three dependent gathers (order index, record, row) per run, hidden
//      by ~8 runs per resident warp; the longest same-slot run is the only
//      serial part.
//   4. ``commit_tail``, one block per writable shard with eligible records:
//      the FREEs in parallel (the j-th FREE's row gets word 0 = the
//      (j-1)-th FREE's target, or the old free head, and zeros elsewhere;
//      only the last FREE of a same-slot run writes, so a row freed twice
//      links to itself as the serial walk leaves it); then one warp pops
//      the free list for the ALLOCs in id order while it lasts, with the
//      records' headers and staged words fetched ahead into a shared ring
//      by cp.async so that only the link read and the row write stay on the
//      chain; then the remaining ALLOCs take bump, bump + 1, ... below
//      ``hi`` in parallel and the rest fault; then the heap registers.
//      Bound by the free-list pops, one dependent access each.
// Step 4 is a second launch after step 3 rather than a last-block ticket:
// the kernel boundary orders every store of step 3 before the FREEs and
// ALLOCs that overwrite or pop the same rows, with no counter to zero every
// phase and no __threadfence on each block's path.
//
// Semantics, exactly ``_commit_phase``'s (and ``ref.commit_shard``'s):
//   * STORE: a masked write; CAS: the same, guarded on the lowest masked
//     word equal to ``expect``;
//   * FREE: the row zeroed, the old free head in word 0, the slot pushed;
//   * ALLOC: pop the free list, else bump while ``bump < hi``, else FAULT;
//     the row, clamped to the shard's (a free list threaded through a
//     twice-freed row can hand out a slot outside it), becomes
//     ``where(mask, data, 0)`` and the slot lands in
//     ``scratch[clip(m_tgt, 0, S - 1)]``;
//   * every eligible record's ``m_op`` is cleared; a shard without
//     PERM_WRITE faults every eligible record and applies nothing;
//   * heap: ``commits += n_eligible`` (CAS misses and exhausted ALLOCs
//     count), ``epoch += n_eligible > 0``.
// The JAX package shifts the int32 mask right arithmetically by the word
// index; XLA fills a shift of 32 or more with the sign, so a mask with bit
// 31 set also selects words 32..W-1.  ``x >> k`` for k >= 32 is undefined
// in C++, hence ``mask >> min(k, 31)``.  Tensor cores have no place here:
// there is no arithmetic to speak of, only dependent accesses.
//
// One shard of a launch: a memory node that holds only its own rows
// (core/routing.py's ProcessGroupMesh) launches over its one pool, its heap
// row and its rows.  `shard0` is the global index of the launch's first
// pool (its heap rows follow the pools) and `row0` the global row of
// data's first row; bounds and perms stay the whole mesh's.  A slot in the
// order key is a row's index in `data` (`cap` counts those rows, so the key
// orders as the global one does), while targets, free-list links and the
// slots ALLOCs write back stay global addresses.  shard0 = row0 = 0 is the
// whole arena and every shard.
//
// The record layout, opcodes and heap registers come from the port's Python
// modules as -D defines (kernels/pulse_commit/kernel.py).

#include <cuda_runtime.h>

#if !defined(PC_F_ID) || !defined(PC_F_HOME) || !defined(PC_F_STATUS) ||               \
    !defined(PC_F_SCRATCH) || !defined(PC_STATUS_EMPTY) || !defined(PC_M_NONE) ||       \
    !defined(PC_M_STORE) || !defined(PC_M_CAS) || !defined(PC_M_ALLOC) ||               \
    !defined(PC_M_FREE) || !defined(PC_H_FREE) || !defined(PC_H_BUMP) ||                \
    !defined(PC_H_EPOCH) || !defined(PC_H_COMMITS) || !defined(PC_HEAP_WORDS) ||        \
    !defined(PC_STATUS_FAULT) || !defined(PC_NULL) || !defined(PC_PERM_WRITE) ||        \
    !defined(PC_MAX_WORDS)
#error "pulse_commit.cu is built by kernels/pulse_commit/kernel.py, which passes its layout"
#endif

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kGroup = 8;                        // lanes per run (W <= 64: <= 8 words a lane)
constexpr int kGroups = kThreads / kGroup;       // runs in flight per block
constexpr int kTile = 2 * kGroups;               // sorted positions per commit_apply block
constexpr int kRing = 8;                         // ALLOC records fetched ahead of the pops
constexpr int kRingWords = 4 + PC_MAX_WORDS;     // header (op, tgt, mask, expect) + staged words

// min(max(x, lo), hi), as the plain versions clamp
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// word w of the staged mask, widened by sign past bit 31 as XLA does
__device__ __forceinline__ bool mask_bit(int mask, int w) {
  return (mask >> (w < 31 ? w : 31)) & 1;
}

// the CAS guard: the lowest masked word, or word 0 when the mask selects none
__device__ __forceinline__ int guard_word(int mask, int W) {
  const int low = __ffs(mask) - 1;
  return (low >= 0 && low < W) ? low : 0;
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The first i in [0, n) with a[i] >= x (n if none), a ascending, by one
// whole warp: each round probes 32 evenly spaced keys, so a pool of 65,536
// records takes 4 dependent loads, not 16.
__device__ int warp_lower_bound(const long long* a, int n, long long x) {
  const int lane = threadIdx.x % kWarp;
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int span = hi - lo;
    const int step = (span + kWarp - 1) / kWarp;
    const int q = lo + min((lane + 1) * step, span) - 1;
    const unsigned ge = __ballot_sync(0xffffffffu, a[q] >= x);
    if (ge == 0) return hi;
    const int j = __ffs(ge) - 1;
    const int qj = __shfl_sync(0xffffffffu, q, j);
    const int qp = __shfl_sync(0xffffffffu, q, j > 0 ? j - 1 : 0);
    lo = j > 0 ? qp + 1 : lo;
    hi = qj;
  }
  return hi;
}

// Step 1: every record's order key.
__global__ void __launch_bounds__(kThreads) commit_key(
    const int* __restrict__ pools, const int* __restrict__ bounds, long long* __restrict__ key,
    int P, int L, int R, int S, int cap, int shard0, int row0) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<long long>(P) * L) return;
  const int s = shard0 + static_cast<int>(i / L);
  const int* rec = pools + i * R;
  const int MB = PC_F_SCRATCH + S;
  const int op = rec[MB];
  const int tgt = rec[MB + 1];
  const bool alloc = op == PC_M_ALLOC;
  bool eligible = op != PC_M_NONE && rec[PC_F_STATUS] != PC_STATUS_EMPTY;
  if (eligible) eligible = alloc ? rec[PC_F_HOME] == s : (tgt >= bounds[s] && tgt < bounds[s + 1]);
  const long long klass = alloc ? 2 : (op == PC_M_FREE ? 1 : 0);
  const long long slot = alloc ? 0 : static_cast<long long>(tgt) - row0;
  key[i] = eligible ? (klass * cap + slot) * L + rec[PC_F_ID] : 3LL * cap * L;
}

// Step 3: the STOREs and CASes, one group of kGroup lanes per same-slot run.
__global__ void __launch_bounds__(kThreads) commit_apply(
    int* __restrict__ pools, int* __restrict__ data, const long long* __restrict__ skey,
    const long long* __restrict__ order, const int* __restrict__ perms, int L, int R, int S,
    int W, int cap, int shard0) {
  const int s = blockIdx.y;
  const int tile = blockIdx.x * kTile;
  const int end = min(tile + kTile, L);
  const long long base = static_cast<long long>(s) * L;
  const long long* sk = skey + base;
  const long long* ord = order + base;
  int* pool = pools + base * R;
  const int MB = PC_F_SCRATCH + S;
  const long long cl = static_cast<long long>(cap) * L;  // the first FREE key
  const long long top = 3 * cl;
  const bool writable = (perms[shard0 + s] & PC_PERM_WRITE) == PC_PERM_WRITE;
  if (sk[tile] >= (writable ? cl : top)) return;  // nothing of this step in the tile

  if (!writable) {
    // write revoked: every eligible commit faults, nothing is applied
    for (int i = tile + threadIdx.x; i < end; i += kThreads) {
      if (sk[i] < top) {
        int* rec = pool + ord[i] * R;
        rec[PC_F_STATUS] = PC_STATUS_FAULT;
        rec[MB] = PC_M_NONE;
      }
    }
    return;
  }

  const int lane = threadIdx.x % kGroup;
  const unsigned gmask = ((1u << kGroup) - 1) << (threadIdx.x % kWarp / kGroup * kGroup);
  for (int i = tile + threadIdx.x / kGroup; i < end; i += kGroups) {
    const long long k = sk[i];
    if (k >= cl) break;  // past the STOREs and CASes (positions ascend)
    const long long slot = k / L;
    if (i > 0 && sk[i - 1] / L == slot) continue;  // inside a run its head applies
    int* row = data + slot * W;
    for (int j = i; j < L; ++j) {
      const long long kj = j == i ? k : sk[j];
      if (kj >= cl || kj / L != slot) break;
      int* rec = pool + ord[j] * R;
      const int op = rec[MB];
      const int mask = rec[MB + 2];
      const bool write = op != PC_M_CAS || row[guard_word(mask, W)] == rec[MB + 3];
      __syncwarp(gmask);  // every lane has read the guard before any writes
      if (write) {
        for (int w = lane; w < W; w += kGroup) {
          if (mask_bit(mask, w)) row[w] = rec[MB + 4 + w];
        }
      }
      __syncwarp(gmask);  // the record is read, and the row written, before the next
      if (lane == 0) rec[MB] = PC_M_NONE;
    }
  }
}

// Step 4: per writable shard, the FREEs, the ALLOCs and the heap registers.
__global__ void __launch_bounds__(kThreads) commit_tail(
    int* __restrict__ pools, int* __restrict__ data, int* __restrict__ heap,
    const long long* __restrict__ skey, const long long* __restrict__ order,
    const int* __restrict__ bounds, const int* __restrict__ perms, int L, int R, int S, int W,
    int cap, int shard0, int row0) {
  const int s = blockIdx.x;  // the pool's index in the launch; shard0 + s its shard
  const long long base = static_cast<long long>(s) * L;
  const long long* sk = skey + base;
  const long long* ord = order + base;
  int* pool = pools + base * R;
  const int MB = PC_F_SCRATCH + S;
  const long long cl = static_cast<long long>(cap) * L;
  if ((perms[shard0 + s] & PC_PERM_WRITE) != PC_PERM_WRITE || sk[0] >= 3 * cl) return;

  __shared__ int edge[3];  // the first FREE, the first ALLOC, the eligible count
  __shared__ int ring[kRing][kRingWords];
  __shared__ long long ring_rec[kRing];
  __shared__ int popped, head_after;
  const int warp = threadIdx.x / kWarp;
  const int wlane = threadIdx.x % kWarp;
  if (warp < 3) {
    const int b = warp_lower_bound(sk, L, (warp + 1) * cl);
    if (wlane == 0) edge[warp] = b;
  }
  __syncthreads();
  const int b1 = edge[0], b2 = edge[1], n = edge[2];
  const int lo = bounds[shard0 + s], hi = bounds[shard0 + s + 1], rows = hi - lo;
  const int base_row = lo - row0;  // the shard's first row in data
  int* h = heap + s * PC_HEAP_WORDS;
  const int free0 = h[PC_H_FREE];
  const int bump = h[PC_H_BUMP];
  const int lane = threadIdx.x % kGroup;

  // FREE, in parallel: a FREE's slot is its key's, (cap + slot) * L + id, a
  // row of data; the link it writes is the previous FREE's global address
  for (int i = b1 + threadIdx.x / kGroup; i < b2; i += kGroups) {
    const int slot = static_cast<int>(sk[i] / L - cap);
    if (i + 1 == b2 || sk[i + 1] / L - cap != slot) {  // the last FREE of its slot writes
      const int link = i == b1 ? free0 : static_cast<int>(sk[i - 1] / L - cap) + row0;
      int* row = data + static_cast<long long>(slot) * W;
      for (int w = lane; w < W; w += kGroup) row[w] = w == 0 ? link : 0;
    }
    if (lane == 0) pool[ord[i] * R + MB] = PC_M_NONE;
  }
  __syncthreads();  // the FREEs' rows are written before a pop reads a link

  // ALLOC from the free list: one warp pops in id order while it lasts
  if (warp == 0) {
    const long long* ordA = ord + b2;
    const int n_alloc = n - b2;
    int head = b2 > b1 ? static_cast<int>(sk[b2 - 1] / L - cap) + row0 : free0;
    int k = 0;
    if (head != PC_NULL && n_alloc > 0) {
      auto fetch = [&](int j, long long r) {  // record j's header and staged words into the ring
        if (j < n_alloc) {
          int* dst = ring[j % kRing];
          const int* src = pool + r * R + MB;
          if (wlane == 0) ring_rec[j % kRing] = r;
          for (int w = wlane; w < 4 + W; w += kWarp) cp_async4(dst + w, src + w);
        }
        cp_async_commit();  // one group per record, empty past the last
      };
      for (int j = 0; j < kRing - 1; ++j) fetch(j, j < n_alloc ? ordA[j] : 0);
      long long next = kRing - 1 < n_alloc ? ordA[kRing - 1] : 0;
      for (; k < n_alloc && head != PC_NULL; ++k) {
        fetch(k + kRing - 1, next);  // into the slot record k - 1 left
        next = k + kRing < n_alloc ? ordA[k + kRing] : 0;  // consumed one pop later
        cp_async_wait<kRing - 1>();  // record k has landed
        __syncwarp();
        const int* e = ring[k % kRing];
        int* rec = pool + ring_rec[k % kRing] * R;
        const int mask = e[2];
        int* row = data + static_cast<long long>(base_row + clampi(head - lo, 0, rows - 1)) * W;
        const int link = row[0];
        __syncwarp();  // the link is read before the row is overwritten
        for (int w = wlane; w < W; w += kWarp) row[w] = mask_bit(mask, w) ? e[4 + w] : 0;
        if (wlane == 0) {
          rec[PC_F_SCRATCH + clampi(e[1], 0, S - 1)] = head;
          rec[MB] = PC_M_NONE;
        }
        head = link;
        __syncwarp();  // this pop's row is written before the next link read
      }
      cp_async_wait<0>();
    }
    if (wlane == 0) {
      popped = k;
      head_after = head;
    }
  }
  __syncthreads();

  // ALLOC from the bump pointer, in parallel: the k-th of the rest takes
  // bump + k below hi, the others fault
  const int first = b2 + popped;
  const int n_rest = n - first;
  const long long room = max(static_cast<long long>(hi) - bump, 0LL);
  const int n_claim = static_cast<int>(min(static_cast<long long>(n_rest), room));
  for (int k = threadIdx.x / kGroup; k < n_rest; k += kGroups) {
    int* rec = pool + ord[first + k] * R;
    if (k < n_claim) {
      const int slot = bump + k;
      // a slot below lo clamps to lo: only the last ALLOC onto that row writes
      if (slot >= lo || k == n_claim - 1) {
        int* row = data + static_cast<long long>(base_row + clampi(slot - lo, 0, rows - 1)) * W;
        const int mask = rec[MB + 2];
        for (int w = lane; w < W; w += kGroup) row[w] = mask_bit(mask, w) ? rec[MB + 4 + w] : 0;
      }
      if (lane == 0) rec[PC_F_SCRATCH + clampi(rec[MB + 1], 0, S - 1)] = slot;
    } else if (lane == 0) {
      rec[PC_F_STATUS] = PC_STATUS_FAULT;  // the shard is out of rows
    }
    if (lane == 0) rec[MB] = PC_M_NONE;
  }
  __syncthreads();  // every thread has read the old registers
  if (threadIdx.x == 0) {
    h[PC_H_FREE] = head_after;
    h[PC_H_BUMP] = bump + n_claim;
    h[PC_H_EPOCH] += 1;
    h[PC_H_COMMITS] += n;
  }
}

cudaError_t check_shape(int P, int L, int W, int S) {
  if (P <= 0 || L <= 0 || W <= 0 || W > PC_MAX_WORDS || S <= 0) return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

extern "C" int pulse_commit_key_launch(const void* pools, const void* bounds, void* key, int P,
                                       int L, int R, int S, int cap, int shard0, int row0,
                                       void* stream) {
  if (P <= 0 || L <= 0) return 0;
  if (S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(P) * L;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  commit_key<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pools), static_cast<const int*>(bounds),
      static_cast<long long*>(key), P, L, R, S, cap, shard0, row0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pulse_commit_apply_launch(void* pools, void* data, const void* skey,
                                         const void* order, const void* perms, int P, int L,
                                         int R, int S, int W, int cap, int shard0,
                                         void* stream) {
  if (P <= 0 || L <= 0) return 0;
  if (const cudaError_t e = check_shape(P, L, W, S)) return static_cast<int>(e);
  const dim3 grid((L + kTile - 1) / kTile, P);
  commit_apply<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(pools), static_cast<int*>(data), static_cast<const long long*>(skey),
      static_cast<const long long*>(order), static_cast<const int*>(perms), L, R, S, W, cap,
      shard0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pulse_commit_tail_launch(void* pools, void* data, void* heap, const void* skey,
                                        const void* order, const void* bounds, const void* perms,
                                        int P, int L, int R, int S, int W, int cap,
                                        int shard0, int row0, void* stream) {
  if (P <= 0 || L <= 0) return 0;
  if (const cudaError_t e = check_shape(P, L, W, S)) return static_cast<int>(e);
  commit_tail<<<P, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(pools), static_cast<int*>(data), static_cast<int*>(heap),
      static_cast<const long long*>(skey), static_cast<const long long*>(order),
      static_cast<const int*>(bounds), static_cast<const int*>(perms), L, R, S, W, cap, shard0,
      row0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pulse_commit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
