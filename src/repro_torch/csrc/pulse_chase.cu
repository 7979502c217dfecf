// pulse_chase: the PULSE accelerator (paper S4.2) as a CUDA kernel for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/pulse_chase/kernel.py::_chase_kernel.
// That kernel takes the iterator's logic as a traced closure; a CUDA kernel
// cannot, so this one has one step loop, templated on the body that runs one
// iteration of a lane:
//   * IsaBody interprets PULSE ISA code -- a (T, 4) int32 array of
//     [op, a, b, imm] rows -- which is the paper's own logic pipeline, with
//     the semantics of repro_torch.core.isa.run_iteration;
//   * the native bodies compute what the structures' iterators written in
//     torch compute (repro_torch.core.structures: list_find, list_sum,
//     hash_find, bst_find, btree_find, btree_range_agg, skiplist_find), bit
//     for bit, including the int32 wraps.
// The node-word offsets, FANOUT, NULL and KEY_NOT_FOUND of each structure,
// the opcodes of the ISA and the body ids reach this file as -D defines
// built from the Python modules (repro_torch/kernels/pulse_chase/kernel.py),
// so the kernel keeps no copy of its own.
//
// Three modes, one body:
//   * fixed depth (mode 0): num_steps iterations for every active lane,
//     counts accumulated on top of it_in; the semantics of
//     repro_torch.kernels.pulse_chase.ref.chase_reference;
//   * one whole traversal (mode 1): a lane entering active with a negative
//     pointer faults at once; a live lane is checked against the fault table
//     (pointer in range, its shard readable) whenever its iteration count is
//     a multiple of `quantum` and once more if it is still live at
//     num_steps; a lane retired on a negative pointer is a fault too.  These
//     are the semantics of the variable-depth wave scheduler of the JAX
//     package with the same depth quantum (ref.chase_run_reference), in one
//     launch and with no host work between steps;
//   * one routing superstep (mode 2): the local chase of every memory node
//     of a mesh emulated on this card, over the request records of all P
//     shards' pools at once, (P * L, R) int32 read with stride R.  Lane i
//     belongs to shard i / L, which serves rows [bounds[s], bounds[s + 1])
//     and reads them when perms[s] grants `need` (or always, with `elide`).
//     Up to num_steps (k_local) times, as iterator.step_batch does: a lane
//     whose pointer lies in its shard's range steps (or faults when its
//     shard does not grant the read); then a lane still active is MAXED at
//     max_iters, and a lane that came in with a NULL pointer faults.  A
//     lane leaves its loop only once nothing can change it: it is no longer
//     active, or its pointer is another shard's and its budget is not
//     spent.  The semantics of ref.chase_superstep_reference.
//     A launch may take one shard of the mesh (a memory node that holds
//     only its own rows, core/routing.py's ProcessGroupMesh): lane i then
//     belongs to shard shard0 + i / L, and `arena` starts at global row
//     row0, so a pointer p reads row p - row0; bounds and perms stay the
//     whole mesh's (shard0 = row0 = 0: the whole arena, every shard).
//     With replica rows (rep_rows, replicated reads), shard s also serves a
//     second window: the range of primary_map[s], whose rows it holds at
//     global row bounds[s] + (ptr - bounds[primary]) of rep_rows, which
//     starts at row0 as `arena` does (one shard's holder slice, or the
//     whole arena's layout), while the policy
//     spreads reads or that primary is marked dead (never while s itself is
//     dead), under the primary's grant; a dead shard's own range is empty.
//     The window sits in the row's address and in the test of locality, so
//     every body takes it unchanged; without replica rows the lane is
//     compiled without it.
//
// What bounds it on this card: every step of a lane is a gather whose
// address depends on the previous step's result, so a lane is a chain of
// dependent memory latencies (device memory, or L2 when the arena fits in
// its 50 MB).  The least time for the same work is the bytes it must move --
// the words a body reads per executed lane-step plus the lane state in and
// out once -- over 3.35 TB/s; a dependent chain runs above that bound.  The
// design:
//   * one thread per lane and as many resident blocks as the card holds
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor); lanes beyond that are
//     taken from a device-side counter, so a thread whose lane retires
//     starts the next one; the warp scheduler overlaps the gathers of the
//     resident lanes (the paper's m:n multiplexing);
//   * a native body keeps its scratch pad and the row words it reads in
//     registers and loads its row with independent 16-byte loads;
//   * the interpreter keeps its 16 registers, its scratch pad (S <= 32) and
//     its node row (W <= 64) in shared memory laid out [slot][thread], so a
//     warp's accesses at one slot hit 32 distinct banks and no dynamically
//     indexed array falls into local memory; the program (decoded: its
//     operands clamped and turned into slot offsets, one int4 a row) and
//     the fault table are staged in shared memory once per block.

#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#if !defined(PULSE_OP_HALT) || !defined(PULSE_OP_GETPTR) || !defined(PULSE_LAST_OP)
#error "build through repro_torch.kernels.pulse_chase.kernel, which defines the opcodes"
#endif
#if !defined(PULSE_NULL) || !defined(BTREE_FANOUT) || !defined(PULSE_BODY_ISA) || \
    !defined(REC_SCRATCH) || !defined(STATUS_FAULT)
#error "build through repro_torch.kernels.pulse_chase.kernel, which defines the layouts"
#endif

// The launch's arguments; kernel.py mirrors this layout as a ctypes
// Structure (pointers first, then ints: no padding on either side).
struct ChaseArgs {  // outside the unnamed namespace: the C entry points take it
  const int* arena;        // (cap, W) rows
  const int* code;         // IsaBody: (T, 4) program rows
  const int* ptr_in;
  const int* scr_in;       // (B, S)
  const int* st_in;
  const int* it_in;        // fixed depth: counts accumulate on top of these
  int* ptr_out;
  int* scr_out;
  int* st_out;
  int* it_out;
  unsigned char* faulted_out;  // run mode
  const int* bounds;       // fault table / superstep: (n_bounds,) sorted shard bases
  const int* perms;        // (n_perms,) permission bits per shard
  int* next_lane;          // work counter (zeroed by the launcher)
  const int* pool_in;      // superstep: (B, R) request records
  int* pool_out;
  const int* rep_rows;     // superstep, replicated reads: (cap, W) replica rows, or null
  const int* primary_map;  // (n_perms,) the primary whose rows each shard holds, or -1
  const unsigned char* dead_mask;  // (n_perms,) shards marked dead
  const int* budget;       // superstep: the lanes' iteration budget on the device, or null
  int cap, W, T, B, S;
  int num_steps;           // steps (fixed depth, superstep) or the budget (run)
  int quantum;             // run: a fault check every `quantum` iterations
  int mode;                // 0: fixed depth, 1: one whole traversal, 2: superstep
  int n_bounds;            // run: 0 for no fault check; superstep: P + 1
  int n_perms;
  int check_cap;           // the fault check's capacity
  int need;                // the permission bits a read needs
  int R;                   // superstep: words of a record
  int L;                   // superstep: records of one shard's pool
  int max_iters;           // superstep: a lane's iteration budget when `budget` is null
  int elide;               // superstep: 1 when every shard's grant is known true
  int rep_spread;          // replicated reads: 1 under the "spread" policy
  int shard0;              // superstep: the shard of the launch's first pool
  int row0;                // superstep: the global row of arena's first row
};

namespace {

constexpr int kThreads = 128;
constexpr int kNumRegs = 16;
constexpr int kRun = 1, kSuperstep = 2;  // ChaseArgs::mode (0: fixed depth)

// the record format of repro_torch.core.routing and the status codes of
// repro_torch.core.iterator
constexpr int kRecPtr = REC_PTR, kRecStatus = REC_STATUS, kRecIters = REC_ITERS,
              kRecScratch = REC_SCRATCH;
constexpr int kActive = STATUS_ACTIVE, kDone = STATUS_DONE, kMaxed = STATUS_MAXED,
              kFault = STATUS_FAULT;

// opcodes of repro_torch.core.isa; the store class (STOREN..FREE) stages
// nothing on the read path
constexpr int HALT = PULSE_OP_HALT, LOADN = PULSE_OP_LOADN,
              LOADS = PULSE_OP_LOADS, STORES = PULSE_OP_STORES,
              ADD = PULSE_OP_ADD, SUB = PULSE_OP_SUB, MUL = PULSE_OP_MUL,
              DIV = PULSE_OP_DIV, AND = PULSE_OP_AND, OR = PULSE_OP_OR,
              NOT = PULSE_OP_NOT, MOVE = PULSE_OP_MOVE, MOVI = PULSE_OP_MOVI,
              JEQ = PULSE_OP_JEQ, JNE = PULSE_OP_JNE, JLT = PULSE_OP_JLT,
              JLE = PULSE_OP_JLE, JGT = PULSE_OP_JGT, JGE = PULSE_OP_JGE,
              JMP = PULSE_OP_JMP, NEXT_ITER = PULSE_OP_NEXT_ITER,
              RETURN = PULSE_OP_RETURN, GETPTR = PULSE_OP_GETPTR,
              LAST_OP = PULSE_LAST_OP;
constexpr int kNull = PULSE_NULL;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// int32 arithmetic that wraps: computed in uint32 (signed overflow is undefined)
__device__ __forceinline__ int wrap_add(int x, int y) {
  return static_cast<int>(static_cast<uint32_t>(x) + static_cast<uint32_t>(y));
}
__device__ __forceinline__ int wrap_sub(int x, int y) {
  return static_cast<int>(static_cast<uint32_t>(x) - static_cast<uint32_t>(y));
}
__device__ __forceinline__ int wrap_mul(int x, int y) {
  return static_cast<int>(static_cast<uint32_t>(x) * static_cast<uint32_t>(y));
}

// DIV is floor division, x / 0 = 0, INT_MIN / -1 = INT_MIN (C's `/`
// truncates toward zero and faults on INT_MIN / -1)
__device__ __forceinline__ int floor_div(int x, int y) {
  if (y == 0) return 0;
  if (x == INT_MIN && y == -1) return INT_MIN;
  int q = x / y;
  if ((x % y != 0) && ((x < 0) != (y < 0))) q -= 1;
  return q;
}

// Words [0, NW) of one node row, in registers: 16-byte loads when the
// arena's rows allow it (W % 4 == 0, aligned base), all issued before any
// is used.
template <int NW>
struct Row {
  static constexpr int kVec = (NW + 3) / 4;
  int w[4 * kVec];
  __device__ __forceinline__ void load(const int* __restrict__ src, bool vec) {
    if (vec) {
      const int4* s4 = reinterpret_cast<const int4*>(src);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const int4 v = __ldg(s4 + i);
        w[4 * i] = v.x; w[4 * i + 1] = v.y; w[4 * i + 2] = v.z; w[4 * i + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < NW; ++i) w[i] = __ldg(src + i);
    }
  }
};

// ------------------------------ native bodies -------------------------------
// Each Impl has kScratch (its scratch-pad words), kRowWords (the row words
// it reads) and logic(r, row, s, p, np) -> done, which updates the scratch
// pad and sets the next pointer as the iterator's torch end_fn then next_fn
// do (repro_torch.kernels.pulse_chase.ops.ChaseLogic).  `r` holds the row's
// words in registers; a word picked by an index known only at run time (a
// B+tree child, value or last key) is read again through `row`, from the
// L1 line the row load just filled, so that no register array is indexed
// at run time.  (Picking it out of the registers with an unrolled chain of
// compares, nvcc 12.8 -O3 summed two neighbouring children on full B+tree
// nodes; the tests on the card hold every body against its torch version.)

// list_find and hash_find: [search_key, value, found]; done on a hit or at
// the chain's tail
template <int KEY, int VALUE, int NEXT, int KNF, int WORDS, int ROW>
struct ChainFind {
  static constexpr int kScratch = WORDS, kRowWords = ROW;
  __device__ __forceinline__ static bool logic(const int* r, const int* __restrict__, int* s, int, int& np) {
    const bool hit = r[KEY] == s[0];
    s[1] = hit ? r[VALUE] : KNF;
    s[2] = hit ? 1 : 0;
    np = r[NEXT];
    return hit || r[NEXT] == kNull;
  }
};

// list_sum: [running_sum, count], both wrapping in int32
struct ListSum {
  static constexpr int kScratch = LIST_SUM_WORDS, kRowWords = LIST_SUM_ROW;
  __device__ __forceinline__ static bool logic(const int* r, const int* __restrict__, int* s, int, int& np) {
    s[0] = wrap_add(s[0], r[LIST_VALUE]);
    s[1] = wrap_add(s[1], 1);
    np = r[LIST_NEXT];
    return r[LIST_NEXT] == kNull;
  }
};

// bst_find (lower-bound descent): remember y when going left; done when the
// next hop would be NULL
struct BstFind {
  static constexpr int kScratch = BST_SCRATCH_WORDS, kRowWords = BST_ROW;
  __device__ __forceinline__ static bool logic(const int* r, const int* __restrict__, int* s, int p, int& np) {
    const bool left = s[BST_S_KEY] <= r[BST_KEY];
    np = left ? r[BST_LEFT] : r[BST_RIGHT];
    if (left) {
      s[BST_S_Y] = p;
      s[BST_S_YKEY] = r[BST_KEY];
      s[BST_S_YVAL] = r[BST_VALUE];
    }
    return np == kNull;
  }
};

constexpr int kFanout = BTREE_FANOUT;

// the slot of children[i], i wrapped once from the end and clamped (btree._take)
__device__ __forceinline__ int btree_child_slot(int i) {
  return clampi(i < 0 ? i + kFanout + 1 : i, 0, kFanout);
}

// first i < num_keys with key <= keys[i], else num_keys (btree._descend_index)
__device__ __forceinline__ int btree_descend(const int* r, int key) {
  const int nk = r[BTREE_NUM_KEYS];
  int idx = nk;
#pragma unroll
  for (int i = kFanout - 1; i >= 0; --i)
    if (i < nk && key <= r[BTREE_KEYS0 + i]) idx = i;
  return idx;
}

// btree_find: descend; at a leaf probe its keys and finish
struct BtreeFind {
  static constexpr int kScratch = BTREE_FIND_WORDS, kRowWords = BTREE_ROW;
  __device__ __forceinline__ static bool logic(const int* r, const int* __restrict__ row, int* s,
                                               int, int& np) {
    const int key = s[0], nk = r[BTREE_NUM_KEYS];
    const bool leaf = r[BTREE_IS_LEAF] == 1;
    int slot = -1;  // the first key equal to the search key
#pragma unroll
    for (int i = kFanout - 1; i >= 0; --i)
      if (i < nk && r[BTREE_KEYS0 + i] == key) slot = i;
    if (leaf) {
      s[1] = slot >= 0 ? __ldg(row + BTREE_VAL0 + slot) : BTREE_KEY_NOT_FOUND;
      s[2] = slot >= 0 ? 1 : 0;
      np = r[BTREE_CHILD0];  // unused: the lane is done
    } else {
      np = __ldg(row + BTREE_CHILD0 + btree_child_slot(btree_descend(r, key)));
    }
    return leaf;
  }
};

// btree_range_agg: descend to the first leaf >= lo, then walk the leaf
// chain accumulating sum/min/max/count of the values with key in [lo, hi]
// (sum and count wrap in int32)
struct BtreeRangeAgg {
  static constexpr int kScratch = BTREE_RA_WORDS, kRowWords = BTREE_ROW;
  __device__ __forceinline__ static bool logic(const int* r, const int* __restrict__ row, int* s,
                                               int, int& np) {
    const int nk = r[BTREE_NUM_KEYS], lo = s[BTREE_RA_LO], hi = s[BTREE_RA_HI];
    const bool leaf = r[BTREE_IS_LEAF] == 1;
    uint32_t sum = 0;
    int mn = BTREE_INT_MAX, mx = BTREE_INT_MIN, count = 0;
#pragma unroll
    for (int i = 0; i < kFanout; ++i) {
      const int k = r[BTREE_KEYS0 + i], v = r[BTREE_VAL0 + i];
      if (leaf && i < nk && k >= lo && k <= hi) {
        sum += static_cast<uint32_t>(v);
        mn = min(mn, v);
        mx = max(mx, v);
        ++count;
      }
    }
    s[BTREE_RA_SUM] = static_cast<int>(static_cast<uint32_t>(s[BTREE_RA_SUM]) + sum);
    s[BTREE_RA_MIN] = min(s[BTREE_RA_MIN], mn);
    s[BTREE_RA_MAX] = max(s[BTREE_RA_MAX], mx);
    s[BTREE_RA_COUNT] = wrap_add(s[BTREE_RA_COUNT], count);
    if (!leaf) {
      np = __ldg(row + BTREE_CHILD0 + btree_child_slot(btree_descend(r, lo)));
      return false;
    }
    // keys[min(num_keys - 1, FANOUT - 1)], or INT_MAX for an empty leaf
    const int last = nk > 0 ? __ldg(row + BTREE_KEYS0 + min(nk - 1, kFanout - 1)) : BTREE_INT_MAX;
    np = r[BTREE_NEXT_LEAF];
    return last > hi || r[BTREE_NEXT_LEAF] == kNull;
  }
};

// skiplist_find (fat pointers): [target, value, found]; jump along the
// highest level whose cached successor key is <= the target; done on a hit
// or when no level can advance.  Every word index is known at compile time.
struct SkiplistFind {
  static constexpr int kScratch = SKIP_FIND_WORDS, kRowWords = SKIP_ROW;
  __device__ __forceinline__ static bool logic(const int* r, const int* __restrict__, int* s, int,
                                               int& np) {
    const int target = s[0];
    const bool hit = r[SKIP_KEY] == target;
    bool can = false;
    np = kNull;
#pragma unroll
    for (int l = 0; l < SKIP_LEVELS; ++l) {  // ascending: the last level that fits is the highest
      if (r[SKIP_NPTR0 + 2 * l + 1] <= target) {
        can = true;
        np = r[SKIP_NPTR0 + 2 * l];
      }
    }
    s[1] = hit ? r[SKIP_VALUE] : SKIP_KEY_NOT_FOUND;
    s[2] = hit ? 1 : 0;
    return hit || !can;
  }
};

// A native body: the scratch pad and the row in registers.
template <class Impl>
struct NativeBody {
  int s[Impl::kScratch];
  __device__ __forceinline__ NativeBody(const ChaseArgs&, const int4*, int*) {}
  __device__ __forceinline__ void begin(const int* __restrict__ src) {
#pragma unroll
    for (int i = 0; i < Impl::kScratch; ++i) s[i] = src[i];
  }
  __device__ __forceinline__ void finish(int* __restrict__ dst) const {
#pragma unroll
    for (int i = 0; i < Impl::kScratch; ++i) dst[i] = s[i];
  }
  __device__ __forceinline__ bool step(const int* __restrict__ row, bool vec, int p, int& np) {
    Row<Impl::kRowWords> r;
    r.load(row, vec);
    return Impl::logic(r.w, row, s, p, np);
  }
};

// ------------------------------ the interpreter -----------------------------

// One program row, decoded once per block when the program is staged: the
// operands clamped as the VM clamps them and turned into offsets into the
// [slot][thread] arrays, packed into one int4 so that an instruction costs
// one shared-memory load:
//   x = op | a * kThreads << 8 | b * kThreads << 20   (offsets < 2048)
//   y = imm
//   z = regs offset of imm | node offset of imm << 16
//   w = scratch offset of imm, or -1 when there is no scratch pad
__device__ __forceinline__ int4 decode_row(const int* __restrict__ row, int W, int S) {
  const int imm = row[3];
  return make_int4(clampi(row[0], 0, LAST_OP) | clampi(row[1], 0, kNumRegs - 1) * kThreads << 8 |
                       clampi(row[2], 0, kNumRegs - 1) * kThreads << 20,
                   imm,
                   clampi(imm, 0, kNumRegs - 1) * kThreads | clampi(imm, 0, W - 1) * kThreads << 16,
                   S > 0 ? clampi(imm, 0, S - 1) * kThreads : -1);
}
static_assert(kNumRegs * kThreads <= 2048, "register offsets must fit in 11 bits");

struct IsaBody {
  const int4* code;  // decoded rows (decode_row)
  int T, S, W;
  int* regs;  // slot r of this thread at regs[r * kThreads]
  int* scr;
  int* node;

  // shared memory after the program and the fault table: registers, scratch
  // pad and node row, each [slot][thread]
  __device__ __forceinline__ IsaBody(const ChaseArgs& a, const int4* s_code, int* room)
      : code(s_code), T(a.T), S(a.S), W(a.W) {
    regs = room + threadIdx.x;
    scr = regs + kNumRegs * kThreads;
    node = scr + a.S * kThreads;
  }
  __device__ __forceinline__ void begin(const int* __restrict__ src) {
    for (int i = 0; i < S; ++i) scr[i * kThreads] = src[i];
  }
  __device__ __forceinline__ void finish(int* __restrict__ dst) const {
    for (int i = 0; i < S; ++i) dst[i] = scr[i * kThreads];
  }
  __device__ __forceinline__ bool step(const int* __restrict__ row, bool vec, int p, int& np) {
    // the single aggregated load of this iteration, all loads issued first
    if (vec) {
      const int4* src4 = reinterpret_cast<const int4*>(row);
      for (int w = 0; w < W / 4; ++w) {
        const int4 v = __ldg(src4 + w);
        node[(4 * w) * kThreads] = v.x;
        node[(4 * w + 1) * kThreads] = v.y;
        node[(4 * w + 2) * kThreads] = v.z;
        node[(4 * w + 3) * kThreads] = v.w;
      }
    } else {
      for (int w = 0; w < W; ++w) node[w * kThreads] = __ldg(row + w);
    }
#pragma unroll
    for (int r = 0; r < kNumRegs; ++r) regs[r * kThreads] = 0;

    // one iteration of the program; jumps go forward only, so T rounds end
    // it.  The row after this one is fetched before this one runs, so a
    // fall-through costs no wait on shared memory.
    bool done = false;
    np = p;
    int pc = 0;
    int4 ins = code[0];
    for (int n = 0; n < T && pc < T; ++n) {
      const int4 after = code[clampi(pc + 1, 0, T - 1)];
      const int op = ins.x & 0xff, a = (ins.x >> 8) & 0xfff, b = ins.x >> 20, imm = ins.y;
      const int ri = ins.z & 0xffff, ni = ins.z >> 16, si = ins.w;
      int next = pc + 1;
      bool halt = false;
      switch (op) {
        case HALT: halt = true; break;
        case LOADN: regs[a] = node[ni]; break;
        case LOADS: regs[a] = si >= 0 ? scr[si] : 0; break;
        case STORES: if (si >= 0) scr[si] = regs[a]; break;
        case ADD: regs[a] = wrap_add(regs[b], regs[ri]); break;
        case SUB: regs[a] = wrap_sub(regs[b], regs[ri]); break;
        case MUL: regs[a] = wrap_mul(regs[b], regs[ri]); break;
        case DIV: regs[a] = floor_div(regs[b], regs[ri]); break;
        case AND: regs[a] = regs[b] & regs[ri]; break;
        case OR: regs[a] = regs[b] | regs[ri]; break;
        case NOT: regs[a] = ~regs[b]; break;
        case MOVE: regs[a] = regs[b]; break;
        case MOVI: regs[a] = imm; break;
        case JEQ: if (regs[a] == regs[b]) next = imm; break;
        case JNE: if (regs[a] != regs[b]) next = imm; break;
        case JLT: if (regs[a] < regs[b]) next = imm; break;
        case JLE: if (regs[a] <= regs[b]) next = imm; break;
        case JGT: if (regs[a] > regs[b]) next = imm; break;
        case JGE: if (regs[a] >= regs[b]) next = imm; break;
        case JMP: next = imm; break;
        case NEXT_ITER: np = regs[a]; halt = true; break;
        case RETURN: done = true; halt = true; break;
        case GETPTR: regs[a] = p; break;
        default: break;
      }
      if (halt) break;
      ins = next == pc + 1 ? after : code[clampi(next, 0, T - 1)];
      pc = next;
    }
    return done;
  }
};

// ------------------------------- the step loop ------------------------------

// the fault check of ops.FaultCheck: out of range, or a shard (found by
// counting the bases <= p, as searchsorted(right) - 1 does) lacking `need`
__device__ __forceinline__ bool faults(int p, const ChaseArgs& a, const int* s_bounds,
                                       const int* s_perms) {
  if (p < 0 || p >= a.check_cap) return true;
  int shard = -1;
  for (int i = 0; i < a.n_bounds; ++i) shard += s_bounds[i] <= p ? 1 : 0;
  return (s_perms[clampi(shard, 0, a.n_perms - 1)] & a.need) != a.need;
}

template <class Body>
__device__ __forceinline__ void run_lane(Body& body, const ChaseArgs& a, const int* s_bounds,
                                         const int* s_perms, bool vec, int lane) {
  const bool run = a.mode == kRun;
  int p = a.ptr_in[lane];
  int st = a.st_in[lane];
  int iters = run ? 0 : a.it_in[lane];
  bool faulted = false;
  const size_t so = static_cast<size_t>(lane) * a.S;
  body.begin(a.scr_in + so);
  if (run && st == 0 && p < 0) {  // NULL entry: a fault on arrival
    st = 1;
    faulted = true;
  }
  const bool check = a.n_bounds > 0;
  // n counts this call's steps; in run mode it is the lane's iteration count
  for (int n = 0, to_check = 0; st == 0; ++n, --to_check) {
    if (check && (to_check == 0 || n == a.num_steps)) {
      to_check = a.quantum;
      if (faults(p, a, s_bounds, s_perms)) {
        st = 1;
        faulted = true;
        break;
      }
    }
    if (n == a.num_steps) break;
    const int* row = a.arena + static_cast<size_t>(clampi(p, 0, a.cap - 1)) * a.W;
    int np;
    const bool done = body.step(row, vec, p, np);
    if (!done) p = np;
    ++iters;
    if (done || p < 0) {  // walking off the structure (NULL) retires too
      st = 1;
      faulted = p < 0;
    }
  }
  a.ptr_out[lane] = p;
  a.st_out[lane] = st;
  a.it_out[lane] = iters;
  if (a.faulted_out != nullptr) a.faulted_out[lane] = faulted ? 1 : 0;
  body.finish(a.scr_out + so);
}

// One superstep of one record (mode 2): iterator.step_batch, k_local times,
// over the record's shard's range (and, with kRep, its replica window:
// s_rep holds four words a shard, [own hi, window lo, window hi, flags],
// flags bit 0 the window is on, bit 1 the primary grants the read).  Every
// word of the record is copied through; ptr, status, iters and the scratch
// pad are written as they end.
template <bool kRep, class Body>
__device__ __forceinline__ void superstep_lane(Body& body, const ChaseArgs& a,
                                               const int* s_bounds, const int* s_perms,
                                               const int* s_rep, bool vec, int lane) {
  const int* __restrict__ rec = a.pool_in + static_cast<size_t>(lane) * a.R;
  int* __restrict__ out = a.pool_out + static_cast<size_t>(lane) * a.R;
  for (int j = 0; j < a.R; ++j) out[j] = rec[j];
  int st = rec[kRecStatus];
  if (st != kActive) return;
  const int shard = a.shard0 + lane / a.L;
  const int lo = s_bounds[shard];
  const bool granted = a.elide != 0 || (s_perms[shard] & a.need) == a.need;
  int hi = s_bounds[shard + 1], rep_lo = 0, rep_hi = 0, flags = 0;
  if constexpr (kRep) {
    hi = s_rep[4 * shard];
    rep_lo = s_rep[4 * shard + 1];
    rep_hi = s_rep[4 * shard + 2];
    flags = s_rep[4 * shard + 3];
  }
  int p = rec[kRecPtr];
  int iters = rec[kRecIters];
  // a captured superstep reads the call's budget here, so one graph serves every budget
  const int max_iters = a.budget != nullptr ? __ldg(a.budget) : a.max_iters;
  body.begin(rec + kRecScratch);
  for (int k = 0; k < a.num_steps && st == kActive; ++k) {
    const bool null_ptr = p == kNull;
    const bool in_rep = kRep && (flags & 1) && p >= rep_lo && p < rep_hi;
    const bool local = in_rep || (p >= lo && p < hi);
    // another shard's pointer, budget left: the router moves it, unchanged
    if (!local && !null_ptr && iters < max_iters) break;
    if (local && !null_ptr) {
      if (!(in_rep ? (flags & 2) != 0 : granted)) {
        st = kFault;
      } else {
        const int* row =
            in_rep ? a.rep_rows + static_cast<size_t>(clampi(p - rep_lo + lo - a.row0, 0, a.cap - 1)) * a.W
                   : a.arena + static_cast<size_t>(clampi(p - a.row0, 0, a.cap - 1)) * a.W;
        int np;
        const bool done = body.step(row, vec, p, np);
        if (!done) p = np;
        ++iters;
        if (done) st = kDone;
      }
    }
    if (st == kActive && iters >= max_iters) st = kMaxed;
    if (null_ptr) st = kFault;  // walked off the structure on an earlier step
  }
  out[kRecPtr] = p;
  out[kRecStatus] = st;
  out[kRecIters] = iters;
  body.finish(out + kRecScratch);
}

template <class Body>
__global__ void __launch_bounds__(kThreads) chase_kernel(const ChaseArgs a) {
  extern __shared__ int4 smem[];
  int4* s_code = smem;  // the program's rows, decoded
  int* s_bounds = reinterpret_cast<int*>(smem + a.T);
  int* s_perms = s_bounds + a.n_bounds;
  const bool superstep = a.mode == kSuperstep;
  const bool rep = superstep && a.rep_rows != nullptr;
  int* s_rep = s_perms + a.n_perms;  // replicated reads: 4 words a shard
  int* room = s_rep + (rep ? 4 * a.n_perms : 0);
  for (int i = threadIdx.x; i < a.T; i += kThreads) s_code[i] = decode_row(a.code + 4 * i, a.W, a.S);
  for (int i = threadIdx.x; i < a.n_bounds; i += kThreads) s_bounds[i] = a.bounds[i];
  for (int i = threadIdx.x; i < a.n_perms; i += kThreads) s_perms[i] = a.perms[i];
  if (rep) {
    for (int s = threadIdx.x; s < a.n_perms; s += kThreads) {
      const int prim = a.primary_map[s];
      const int ps = clampi(prim, 0, a.n_perms - 1);
      const bool dead = a.dead_mask[s] != 0;
      const bool on = prim >= 0 && !dead && (a.rep_spread != 0 || a.dead_mask[ps] != 0);
      const bool ok = (a.perms[ps] & a.need) == a.need;
      s_rep[4 * s] = dead ? a.bounds[s] : a.bounds[s + 1];  // a dead shard serves none of its own
      s_rep[4 * s + 1] = a.bounds[ps];
      s_rep[4 * s + 2] = a.bounds[ps + 1];
      s_rep[4 * s + 3] = (on ? 1 : 0) | (ok ? 2 : 0);
    }
  }
  __syncthreads();

  Body body(a, s_code, room);
  const bool vec = (a.W % 4 == 0) && (reinterpret_cast<uintptr_t>(a.arena) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(a.rep_rows) % 16 == 0);
  int lane = blockIdx.x * kThreads + threadIdx.x;
  const int resident = gridDim.x * kThreads;
  while (lane < a.B) {
    if (rep)
      superstep_lane<true>(body, a, s_bounds, s_perms, s_rep, vec, lane);
    else if (superstep)
      superstep_lane<false>(body, a, s_bounds, s_perms, nullptr, vec, lane);
    else
      run_lane(body, a, s_bounds, s_perms, vec, lane);
    if (a.next_lane == nullptr) break;
    lane = resident + atomicAdd(a.next_lane, 1);
  }
}

// shared memory of one block: the program, the fault table, the replica
// windows and, for the interpreter, its registers, scratch pads and node rows
size_t smem_bytes(bool isa, const ChaseArgs& a) {
  size_t words = static_cast<size_t>(a.n_bounds) + a.n_perms;
  if (a.mode == kSuperstep && a.rep_rows != nullptr) words += static_cast<size_t>(4) * a.n_perms;
  if (isa) words += static_cast<size_t>(4) * a.T + static_cast<size_t>(kNumRegs + a.S + a.W) * kThreads;
  return words * sizeof(int);
}

template <class Body>
cudaError_t blocks_per_sm(size_t smem, int* per_sm) {
  static size_t configured = 0;  // the largest dynamic shared memory allowed so far
  if (smem > 48 * 1024 && smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        chase_kernel<Body>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, chase_kernel<Body>, kThreads,
                                                        smem);
}

template <class Body>
cudaError_t launch_body(const ChaseArgs& a, size_t smem, cudaStream_t stream, int* grid_out) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = blocks_per_sm<Body>(smem, &per_sm);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  const int blocks = (a.B + kThreads - 1) / kThreads;
  const int grid = blocks < per_sm * sms ? blocks : per_sm * sms;
  ChaseArgs args = a;
  if (grid < blocks) {  // more lanes than resident threads: a work counter
    if (args.next_lane == nullptr) return cudaErrorInvalidValue;
    if ((e = cudaMemsetAsync(args.next_lane, 0, sizeof(int), stream)) != cudaSuccess) return e;
  } else {
    args.next_lane = nullptr;
  }
  chase_kernel<Body><<<grid, kThreads, smem, stream>>>(args);
  if (grid_out != nullptr) *grid_out = grid;
  return cudaGetLastError();
}

using ListFind = ChainFind<LIST_KEY, LIST_VALUE, LIST_NEXT, LIST_KEY_NOT_FOUND,
                           LIST_FIND_WORDS, LIST_FIND_ROW>;
using HashFind = ChainFind<HASH_KEY, HASH_VALUE, HASH_NEXT, HASH_KEY_NOT_FOUND,
                           HASH_FIND_WORDS, HASH_FIND_ROW>;

template <class F>
cudaError_t with_body(int body, F&& f) {
  switch (body) {
    case PULSE_BODY_ISA: return f(static_cast<IsaBody*>(nullptr));
    case PULSE_BODY_LIST_FIND: return f(static_cast<NativeBody<ListFind>*>(nullptr));
    case PULSE_BODY_LIST_SUM: return f(static_cast<NativeBody<ListSum>*>(nullptr));
    case PULSE_BODY_HASH_FIND: return f(static_cast<NativeBody<HashFind>*>(nullptr));
    case PULSE_BODY_BST_FIND: return f(static_cast<NativeBody<BstFind>*>(nullptr));
    case PULSE_BODY_BTREE_FIND: return f(static_cast<NativeBody<BtreeFind>*>(nullptr));
    case PULSE_BODY_BTREE_RANGE_AGG: return f(static_cast<NativeBody<BtreeRangeAgg>*>(nullptr));
    case PULSE_BODY_SKIPLIST_FIND: return f(static_cast<NativeBody<SkiplistFind>*>(nullptr));
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One launch with the body `body` (a PULSE_BODY_* id) on `stream`; writes
// the grid it chose to *grid (may be null).  Returns a CUDA error code (0 on
// a clean launch); does not synchronise.
extern "C" int pulse_chase_launch(int body, const ChaseArgs* a, void* stream, int* grid) {
  if (a->B <= 0) return 0;
  const size_t smem = smem_bytes(body == PULSE_BODY_ISA, *a);
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_body(body, [&](auto* tag) {
    return launch_body<std::remove_pointer_t<decltype(tag)>>(*a, smem, st, grid);
  }));
}

// Resident blocks of `kThreads` threads per SM for `body` at the shared
// memory a launch with these arguments takes.
extern "C" int pulse_chase_blocks_per_sm(int body, const ChaseArgs* a, int* per_sm) {
  const size_t smem = smem_bytes(body == PULSE_BODY_ISA, *a);
  return static_cast<int>(with_body(body, [&](auto* tag) {
    return blocks_per_sm<std::remove_pointer_t<decltype(tag)>>(smem, per_sm);
  }));
}

extern "C" const char* pulse_chase_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
