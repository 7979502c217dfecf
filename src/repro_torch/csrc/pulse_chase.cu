// pulse_chase: the PULSE accelerator (paper S4.2) as a CUDA kernel for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/pulse_chase/kernel.py::_chase_kernel.
// That kernel takes the iterator's logic as a traced closure; a CUDA kernel
// cannot, so this one takes it as PULSE ISA code -- a (T, 4) int32 array of
// [op, a, b, imm] rows -- and interprets it, which is the paper's own logic
// pipeline.  Semantics are those of repro_torch.kernels.pulse_chase.ref
// (chase_reference) with repro_torch.core.isa.run_iteration as the logic,
// bit for bit.
//
// What bounds it on this card: every step of a lane is a gather whose
// address depends on the previous step's result, so a lane is a chain of
// dependent memory latencies (device memory, or L2 when the arena fits in
// its 50 MB).  The least time for the same work is the bytes it must move
// -- W*4 bytes per executed lane-step plus the lane state in and out once --
// over 3.35 TB/s; a dependent chain runs far above that bound.  The design
// answers with many resident lanes: one thread per lane, 128-thread blocks,
// and no synchronisation between lanes after the program is staged, so the
// warp scheduler overlaps the gathers of many warps on each SM (the paper's
// m:n multiplexing of memory and logic pipelines).
//
// Per step, an active lane copies its node row (W <= 64 words) from the
// arena at clamp(ptr, 0, cap-1) into its own slice of shared memory (the
// single aggregated load; 16-byte loads when the rows allow it), then runs
// one iteration of the program with 16 int32 registers, zeroed every
// iteration, and its scratch pad (S <= 32 words).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kNumRegs = 16;
constexpr int kMaxScratch = 32;

// opcodes of repro_torch.core.isa, passed by the build in
// repro_torch/kernels/pulse_chase/kernel.py as -DPULSE_OP_<NAME>=<code>;
// the store class (STOREN..FREE) stages nothing on the read path
#if !defined(PULSE_OP_HALT) || !defined(PULSE_OP_GETPTR) || !defined(PULSE_LAST_OP)
#error "build through repro_torch.kernels.pulse_chase.kernel, which defines the opcodes"
#endif
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

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// ADD/SUB/MUL wrap in int32: compute in uint32 (signed overflow is undefined)
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

__global__ void __launch_bounds__(kThreads) pulse_chase_kernel(
    const int* __restrict__ arena, int cap, int W, int vec,
    const int* __restrict__ code, int T,
    const int* __restrict__ ptr_in, const int* __restrict__ scr_in,
    const int* __restrict__ st_in, const int* __restrict__ it_in,
    int* __restrict__ ptr_out, int* __restrict__ scr_out,
    int* __restrict__ st_out, int* __restrict__ it_out,
    int B, int S, int num_steps) {
  extern __shared__ int4 smem[];
  int4* s_code = smem;                              // T program rows
  int* s_nodes = reinterpret_cast<int*>(smem + T);  // kThreads rows of W
  int* s_code_words = reinterpret_cast<int*>(s_code);
  for (int i = threadIdx.x; i < 4 * T; i += blockDim.x) s_code_words[i] = code[i];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  int* node = s_nodes + threadIdx.x * W;

  int p = ptr_in[lane];
  int st = st_in[lane];
  int iters = it_in[lane];
  int scr[kMaxScratch];
  for (int s = 0; s < S; ++s) scr[s] = scr_in[static_cast<size_t>(lane) * S + s];

  // a retired lane never changes again, so it leaves the step loop
  for (int step = 0; step < num_steps && st == 0; ++step) {
    // the single aggregated load of this iteration
    const int* src = arena + static_cast<size_t>(clampi(p, 0, cap - 1)) * W;
    if (vec) {
      const int4* src4 = reinterpret_cast<const int4*>(src);
      int4* dst4 = reinterpret_cast<int4*>(node);
      for (int w = 0; w < W / 4; ++w) dst4[w] = src4[w];
    } else {
      for (int w = 0; w < W; ++w) node[w] = src[w];
    }

    // one iteration of the program; jumps go forward only, so T rounds end it
    int regs[kNumRegs];
    for (int r = 0; r < kNumRegs; ++r) regs[r] = 0;
    bool done = false;
    int out_ptr = p;
    int pc = 0;
    for (int n = 0; n < T && pc < T; ++n) {
      const int4 ins = s_code[clampi(pc, 0, T - 1)];
      const int op = clampi(ins.x, 0, LAST_OP);
      const int a = clampi(ins.y, 0, kNumRegs - 1);
      const int b = clampi(ins.z, 0, kNumRegs - 1);
      const int imm = ins.w;
      const int ra = regs[a];
      const int rb = regs[b];
      const int rimm = regs[clampi(imm, 0, kNumRegs - 1)];
      int next = pc + 1;
      bool halt = false;
      switch (op) {
        case HALT: halt = true; break;
        case LOADN: regs[a] = node[clampi(imm, 0, W - 1)]; break;
        case LOADS: regs[a] = S > 0 ? scr[clampi(imm, 0, S - 1)] : 0; break;
        case STORES: if (S > 0) scr[clampi(imm, 0, S - 1)] = ra; break;
        case ADD: regs[a] = wrap_add(rb, rimm); break;
        case SUB: regs[a] = wrap_sub(rb, rimm); break;
        case MUL: regs[a] = wrap_mul(rb, rimm); break;
        case DIV: regs[a] = floor_div(rb, rimm); break;
        case AND: regs[a] = rb & rimm; break;
        case OR: regs[a] = rb | rimm; break;
        case NOT: regs[a] = ~rb; break;
        case MOVE: regs[a] = rb; break;
        case MOVI: regs[a] = imm; break;
        case JEQ: if (ra == rb) next = imm; break;
        case JNE: if (ra != rb) next = imm; break;
        case JLT: if (ra < rb) next = imm; break;
        case JLE: if (ra <= rb) next = imm; break;
        case JGT: if (ra > rb) next = imm; break;
        case JGE: if (ra >= rb) next = imm; break;
        case JMP: next = imm; break;
        case NEXT_ITER: out_ptr = ra; halt = true; break;
        case RETURN: done = true; halt = true; break;
        case GETPTR: regs[a] = p; break;
        default: break;
      }
      if (halt) break;
      pc = next;
    }

    // masked update of kernel.py::_chase_kernel (logic_wave)
    if (!done) p = out_ptr;
    ++iters;
    if (done || p < 0) st = 1;
  }

  ptr_out[lane] = p;
  st_out[lane] = st;
  it_out[lane] = iters;
  for (int s = 0; s < S; ++s) scr_out[static_cast<size_t>(lane) * S + s] = scr[s];
}

}  // namespace

extern "C" int pulse_chase_launch(
    const void* arena, int cap, int W, const void* code, int T,
    const void* ptr_in, const void* scr_in, const void* st_in, const void* it_in,
    void* ptr_out, void* scr_out, void* st_out, void* it_out,
    int B, int S, int num_steps, void* stream) {
  if (B <= 0) return 0;
  const int vec = (W % 4 == 0) && (reinterpret_cast<uintptr_t>(arena) % 16 == 0);
  const size_t smem = static_cast<size_t>(T) * sizeof(int4) +
                      static_cast<size_t>(kThreads) * W * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pulse_chase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (B + kThreads - 1) / kThreads;
  pulse_chase_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(arena), cap, W, vec, static_cast<const int*>(code), T,
      static_cast<const int*>(ptr_in), static_cast<const int*>(scr_in),
      static_cast<const int*>(st_in), static_cast<const int*>(it_in),
      static_cast<int*>(ptr_out), static_cast<int*>(scr_out),
      static_cast<int*>(st_out), static_cast<int*>(it_out), B, S, num_steps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pulse_chase_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
