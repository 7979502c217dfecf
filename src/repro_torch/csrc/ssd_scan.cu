// ssd_scan: the Mamba2 SSD chunked scan (arXiv:2405.21060 S6) for Hopper
// (sm_90a), chunk-parallel, its products on the tensor cores in 3xTF32.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py::_ssd_kernel
// (launched by ssd_scan_pallas).  Same contract: x (B, L, H, dh), dt
// (B, L, H), A (H,), and one B/C group (B, L, N) shared by all heads; for
// each (b, h) the chunks of Q rows are taken in order from S = 0, and per
// chunk, with cs = cumsum(dt * A),
//   y = ((C B^T) o Lmat) (x dt) + exp(cs) o (C S),
//       Lmat[i, j] = exp(cs_i - cs_j) for j <= i, else 0 (masked before the
//       exp: a positive difference would overflow to inf, and inf * 0 = NaN),
//   S <- exp(cs_last) S + B^T (exp(cs_last - cs) o x dt).
// y comes back in x's dtype (f32 or bf16), the final S (B, H, N, dh) in f32.
//
// The TPU kernel runs its grid (B, H, chunks) in order on one core and
// carries S across chunk steps in VMEM.  Here the chunk axis is parallel,
// as in the SSD paper's own split (S6), in three kernels per call:
//   1. ssd_chunk_state, per (b, chunk, tile of TH heads): cs of each head
//      (into a scratch the other two read) and the chunk's own state
//      s_c = B^T (exp(cs_last - cs) o dt o x), N x dh, into an f32 scratch;
//   2. ssd_state_pass, per (b, h, four state entries): S_{c+1} =
//      exp(cs_last,c) S_c + s_c over the chunks in order, overwriting s_c
//      with the state that enters chunk c, and the final state;
//   3. ssd_chunk_scan, per (b, chunk, tile of TH heads): G = C B^T, Q x Q,
//      formed once and kept in registers for all TH heads, then per head
//      y = exp(cs) o (C S_c) + (G o Lmat o dt) x.
// The wrapper picks TH so the grid fills the card's SMs once (one block per
// SM), so C B^T is formed B L H / (chunk TH) times, not once per head as in
// the TPU kernel.
//
// Every product runs on mma.sync m16n8k8 in 3xTF32 (mma_tf32x3.cuh): f32
// accuracy on the TF32 tensor cores.  A warp owns 16 rows of an output
// (a 16 x Q strip of G and 16 x dh of y in kernel 3; 16 x 32 tiles of s_c in
// kernel 1).  Key-indexed operands come out of G's accumulators in the
// C-fragment layout, (row g, keys 2t and 2t + 1); the product uses them as
// an A fragment whose k-slot t stands for key 2t and t + 4 for 2t + 1, and
// reads x's rows in that same order, so no shuffle is needed.  Operands
// move with cp.async: a chunk's B (and C) once per block, then each head's
// x (and S_c) into a double buffer, the next head's copies in flight while
// this head computes.  Shared memory rows are padded so each fragment load
// hits 32 distinct banks.  bf16 x is widened to f32 in the product; it is
// exact in TF32, so its small part (and that pass) is dropped.
//
// What bounds it on this card: operations.  At the serve shape (B 4, L 512,
// H 48, dh 64, N 128, Q 128) the work is ~4.07 GFLOP (C B^T and the
// intra-chunk product over the causal half, C S and the state update over
// all of it) against ~59 MB of inputs and outputs: ~0.061 ms at the f32
// FMA peak of 67 TFLOP/s; 3xTF32 issues three TF32 products for each, 12.2
// GFLOP at 495 TFLOP/s, ~0.025 ms.  The scratch (25 MB at that shape)
// fits in the 50 MB L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "mma_tf32x3.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 128;  // longest chunk: 8 warps x 16 rows
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  void* y;
  float* S_out;
  float* states;  // (Bt, nc, H, N, dh): s_c after kernel 1, S entering chunk c after kernel 2
  float* cs;      // (Bt, H, L): cumsum(dt * A) within each chunk
  long long sxb, sxl, sxh;  // x strides (elements); dh is contiguous
  long long sdb, sdl, sdh;  // dt strides
  long long sbb, sbl;       // B strides; N is contiguous
  long long scb, scl;       // C strides
  long long sA;             // A stride
  int H, L, Q, nc, TH;      // TH heads per block in kernels 1 and 3
};

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ------------------------------ kernel 1 ------------------------------------

template <typename T, int N, int DH>
struct StateSmem {
  static constexpr int kLdB = N + 8;   // B read transposed: banks 8t + g
  static constexpr int kLdX = DH + 8;  // rows t and t + 4: banks 8t + g (f32), 4t + g/2 (bf16)
  static constexpr size_t kB = sizeof(float) * kMaxQ * kLdB;
  static constexpr size_t kX = sizeof(T) * kMaxQ * kLdX;
  static constexpr size_t kBytes = kB + 2 * kX + 3 * sizeof(float) * kMaxQ;
};

template <typename T, int N, int DH>
__global__ void __launch_bounds__(kThreads, 1) ssd_chunk_state(Args a) {
  using Sm = StateSmem<T, N, DH>;
  constexpr int kLdB = Sm::kLdB, kLdX = Sm::kLdX;
  constexpr int WN = DH < 32 ? DH : 32;  // columns of a warp's tile of s_c
  constexpr int NT = WN / 8;
  constexpr int kColTiles = DH / WN;
  constexpr int kTiles = (N / 16) * kColTiles;
  constexpr bool kExactX = !std::is_same<T, float>::value;

  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  float* Bs = reinterpret_cast<float*>(base);                   // [kMaxQ][kLdB]
  T* Xs = reinterpret_cast<T*>(base + Sm::kB);                  // [2][kMaxQ][kLdX]
  float* wd = reinterpret_cast<float*>(base + Sm::kB + 2 * Sm::kX);  // exp(cs_last - cs) dt
  float* dts = wd + kMaxQ;
  float* css = dts + kMaxQ;

  const int c = blockIdx.x, b = blockIdx.y, h0 = blockIdx.z * a.TH;
  const int nh = min(a.TH, a.H - h0);
  const int Q = a.Q, c0 = c * Q, Q8 = (Q + 7) & ~7;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const T* xg = static_cast<const T*>(a.x) + b * a.sxb + c0 * a.sxl;

  tc::load_rows_async(Bs, kLdB, a.B + b * a.sbb + c0 * a.sbl, a.sbl, N, Q8, Q);
  tc::load_rows_async(Xs, kLdX, xg + h0 * a.sxh, a.sxl, DH, Q8, Q);
  tc::cp_async_commit();

  for (int hi = 0; hi < nh; ++hi) {
    const int h = h0 + hi;
    for (int j = tid; j < Q; j += kThreads) dts[j] = a.dt[b * a.sdb + (c0 + j) * a.sdl + h * a.sdh];
    __syncthreads();  // dts is written; head hi - 1 is done with wd and its x buffer
    if (hi + 1 < nh)
      tc::load_rows_async(Xs + ((hi + 1) & 1) * kMaxQ * kLdX, kLdX, xg + (h + 1) * a.sxh, a.sxl,
                          DH, Q8, Q);
    tc::cp_async_commit();
    if (warp == 0) {  // cs by a scan of 32 at a time, then the state update's weights
      const float Ah = a.A[h * a.sA];
      float carry = 0.f;
      for (int s0 = 0; s0 < Q; s0 += 32) {
        const int j = s0 + lane;
        float v = j < Q ? dts[j] * Ah : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += u;
        }
        v += carry;
        if (j < Q) css[j] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
      __syncwarp();
      float* csg = a.cs + ((long long)b * a.H + h) * a.L + c0;
      for (int j = lane; j < Q8; j += 32) {
        wd[j] = j < Q ? expf(carry - css[j]) * dts[j] : 0.f;
        if (j < Q) csg[j] = css[j];
      }
    }
    tc::cp_async_wait<1>();  // this head's x (and B) have landed; the next head's may fly
    __syncthreads();

    const T* Xc = Xs + (hi & 1) * kMaxQ * kLdX;
    float* st = a.states + (((long long)b * a.nc + c) * a.H + h) * N * DH;
    for (int tile = warp; tile < kTiles; tile += kWarps) {
      const int r0 = (tile / kColTiles) * 16, cb = (tile % kColTiles) * WN;
      float acc[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll 4
      for (int j0 = 0; j0 < Q8; j0 += 8) {
        // A = (B^T) scaled by the weights along k: rows r0 + g (+8), keys j0 + t (+4)
        const float w0 = wd[j0 + t], w1 = wd[j0 + t + 4];
        const float* B0 = Bs + (j0 + t) * kLdB + r0 + g;
        const float* B1 = B0 + 4 * kLdB;
        const float av[4] = {B0[0] * w0, B0[8] * w0, B1[0] * w1, B1[8] * w1};
        uint32_t ab[4], as[4];
        tc::split(av, ab, as);
        uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const T* X0 = Xc + (j0 + t) * kLdX + cb + 8 * n + g;
          tc::split(tc::to_f32(X0[0]), bb[n][0], bs[n][0]);
          tc::split(tc::to_f32(X0[4 * kLdX]), bb[n][1], bs[n][1]);
        }
        tc::mma_3xtf32<NT, kExactX>(acc, ab, as, bb, bs);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float* o = st + (r0 + g) * DH + cb + 8 * n + 2 * t;
        store2(o, acc[n][0], acc[n][1]);
        store2(o + 8 * DH, acc[n][2], acc[n][3]);
      }
    }
  }
}

// ------------------------------ kernel 2 ------------------------------------

// One thread per four consecutive state entries of one (b, h).
__global__ void __launch_bounds__(256) ssd_state_pass(Args a, int Bt, int ND) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int per = ND / 4;
  if (idx >= (long long)Bt * a.H * per) return;
  const int bh = static_cast<int>(idx / per), e = static_cast<int>(idx % per);
  const int b = bh / a.H, h = bh % a.H;
  const float* csl = a.cs + (long long)bh * a.L + a.Q - 1;
  float4* p = reinterpret_cast<float4*>(a.states + ((long long)b * a.nc * a.H + h) * ND) + e;
  const long long step = (long long)a.H * ND / 4;  // from chunk c to c + 1
  float4 S = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < a.nc; c0 += 4) {  // four chunks' loads in flight at once
    float4 s[4];
    float d[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (c0 + u < a.nc) {
        s[u] = p[(c0 + u) * step];
        d[u] = expf(csl[(long long)(c0 + u) * a.Q]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (c0 + u < a.nc) {
        p[(c0 + u) * step] = S;
        S = make_float4(fmaf(d[u], S.x, s[u].x), fmaf(d[u], S.y, s[u].y),
                        fmaf(d[u], S.z, s[u].z), fmaf(d[u], S.w, s[u].w));
      }
    }
  }
  reinterpret_cast<float4*>(a.S_out + (long long)bh * ND)[e] = S;
}

// ------------------------------ kernel 3 ------------------------------------

template <typename T, int N, int DH>
struct ScanSmem {
  static constexpr int kLdC = N + 4;                   // C and B rows: banks 4g + t
  static constexpr int kLdX = DH + 16 / sizeof(T);     // x rows 2t, 2t + 1: 8t + g (f32)
  static constexpr int kLdS = DH + 8;                  // S rows t, t + 4: 8t + g
  static constexpr size_t kC = sizeof(float) * kMaxQ * kLdC;
  static constexpr size_t kX = sizeof(T) * kMaxQ * kLdX;
  static constexpr size_t kS = sizeof(float) * N * kLdS;
  static constexpr size_t kHead = kX + kS + 2 * sizeof(float) * kMaxQ;  // x, S_c, cs, dt
  static constexpr size_t kBytes = kC + kHead + (kHead > kC ? kHead : kC);
};

template <typename T, int N, int DH>
__global__ void __launch_bounds__(kThreads, 1) ssd_chunk_scan(Args a) {
  using Sm = ScanSmem<T, N, DH>;
  constexpr int kLdC = Sm::kLdC, kLdX = Sm::kLdX, kLdS = Sm::kLdS;
  constexpr int NT = DH / 8;
  constexpr int kKeyTiles = kMaxQ / 8;
  constexpr bool kExactX = !std::is_same<T, float>::value;

  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  float* Cs = reinterpret_cast<float*>(base);               // [kMaxQ][kLdC]
  char* heads[2] = {base + Sm::kC, base + Sm::kC + Sm::kHead};
  float* Bs = reinterpret_cast<float*>(heads[1]);           // [kMaxQ][kLdC] until G is formed

  const int c = blockIdx.x, b = blockIdx.y, h0 = blockIdx.z * a.TH;
  const int nh = min(a.TH, a.H - h0);
  const int Q = a.Q, c0 = c * Q, Q16 = (Q + 15) & ~15;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const T* xg = static_cast<const T*>(a.x) + b * a.sxb + c0 * a.sxl;

  auto x_of = [&](int i) { return reinterpret_cast<T*>(heads[i]); };
  auto S_of = [&](int i) { return reinterpret_cast<float*>(heads[i] + Sm::kX); };
  auto cs_of = [&](int i) { return reinterpret_cast<float*>(heads[i] + Sm::kX + Sm::kS); };
  auto dt_of = [&](int i) { return cs_of(i) + kMaxQ; };
  auto load_head = [&](int i, int h) {  // cp.async for x and S_c; cs and dt by plain loads
    tc::load_rows_async(x_of(i), kLdX, xg + h * a.sxh, a.sxl, DH, Q16, Q);
    if (c > 0)
      tc::load_rows_async(S_of(i), kLdS, a.states + (((long long)b * a.nc + c) * a.H + h) * N * DH,
                          DH, DH, N, N);
    const float* csg = a.cs + ((long long)b * a.H + h) * a.L + c0;
    float* css = cs_of(i);
    float* dts = dt_of(i);
    for (int j = tid; j < Q16; j += kThreads) {  // cs in log2 units: exp(x) = exp2(x log2(e))
      css[j] = j < Q ? csg[j] * kLog2e : 0.f;
      dts[j] = j < Q ? a.dt[b * a.sdb + (c0 + j) * a.sdl + h * a.sdh] : 0.f;
    }
  };

  tc::load_rows_async(Cs, kLdC, a.C + b * a.scb + c0 * a.scl, a.scl, N, Q16, Q);
  tc::load_rows_async(Bs, kLdC, a.B + b * a.sbb + c0 * a.sbl, a.sbl, N, Q16, Q);
  load_head(0, h0);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();

  // G = C B^T on this warp's 16 rows, over the key tiles up to its
  // diagonal.  Warps w and w + 4 share a scheduler, so they take strips w
  // and 7 - w: each scheduler gets the same causal work.
  const int strip = warp < 4 ? warp : 11 - warp;
  const int i0 = strip * 16;
  const bool active = i0 < Q;
  const int nj = min((Q + 7) / 8, 2 * strip + 2);
  float G[kKeyTiles][4];
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) G[j][0] = G[j][1] = G[j][2] = G[j][3] = 0.f;
  if (active) {
    for (int k0 = 0; k0 < N; k0 += 8) {
      const float* C0 = Cs + (i0 + g) * kLdC + k0 + t;
      const float av[4] = {C0[0], C0[8 * kLdC], C0[4], C0[8 * kLdC + 4]};
      uint32_t ab[4], as[4];
      tc::split(av, ab, as);
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
        if (j < nj) {
          const float* B0 = Bs + (8 * j + g) * kLdC + k0 + t;
          uint32_t bb[2], bs[2];
          tc::split(B0[0], bb[0], bs[0]);
          tc::split(B0[4], bb[1], bs[1]);
          tc::mma_tf32(G[j], as, bb);
          tc::mma_tf32(G[j], ab, bs);
          tc::mma_tf32(G[j], ab, bb);
        }
      }
    }
  }
  __syncthreads();  // B is read no more: its buffer takes the next head

  const int r0 = i0 + g, r1 = r0 + 8;
  for (int hi = 0; hi < nh; ++hi) {
    const int h = h0 + hi;
    if (hi > 0) __syncthreads();  // head hi - 1 is done with the buffer refilled next
    if (hi + 1 < nh) load_head((hi + 1) & 1, h + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    if (!active) continue;

    const T* Xc = x_of(hi & 1);
    const float* Sc = S_of(hi & 1);
    const float* css = cs_of(hi & 1);
    const float* dts = dt_of(hi & 1);
    const float cs0 = css[r0], cs1 = css[r1];
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

    if (c > 0) {  // exp(cs) o (C S_c); S_0 = 0
#pragma unroll 4
      for (int k0 = 0; k0 < N; k0 += 8) {
        const float* C0 = Cs + (i0 + g) * kLdC + k0 + t;
        const float av[4] = {C0[0], C0[8 * kLdC], C0[4], C0[8 * kLdC + 4]};
        uint32_t ab[4], as[4];
        tc::split(av, ab, as);
        uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float* S0 = Sc + (k0 + t) * kLdS + 8 * n + g;
          tc::split(S0[0], bb[n][0], bs[n][0]);
          tc::split(S0[4 * kLdS], bb[n][1], bs[n][1]);
        }
        tc::mma_3xtf32<NT>(acc, ab, as, bb, bs);
      }
      const float e0 = exp2f(cs0), e1 = exp2f(cs1);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][0] *= e0; acc[n][1] *= e0;
        acc[n][2] *= e1; acc[n][3] *= e1;
      }
    }

    // (G o Lmat o dt) x: key tile j of G's accumulators is the A fragment,
    // k-slot t standing for key 8j + 2t and t + 4 for 8j + 2t + 1
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      if (j < nj) {
        const int k0 = 8 * j + 2 * t, k1 = k0 + 1;
        const float ck0 = css[k0], ck1 = css[k1], d0 = dts[k0], d1 = dts[k1];
        // masked before the exp: only k <= r < Q reaches it
        const float av[4] = {
            (k0 <= r0 && r0 < Q) ? G[j][0] * exp2f(cs0 - ck0) * d0 : 0.f,
            (k0 <= r1 && r1 < Q) ? G[j][2] * exp2f(cs1 - ck0) * d0 : 0.f,
            (k1 <= r0 && r0 < Q) ? G[j][1] * exp2f(cs0 - ck1) * d1 : 0.f,
            (k1 <= r1 && r1 < Q) ? G[j][3] * exp2f(cs1 - ck1) * d1 : 0.f,
        };
        uint32_t ab[4], as[4];
        tc::split(av, ab, as);
        uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const T* X0 = Xc + k0 * kLdX + 8 * n + g;
          tc::split(tc::to_f32(X0[0]), bb[n][0], bs[n][0]);
          tc::split(tc::to_f32(X0[kLdX]), bb[n][1], bs[n][1]);
        }
        tc::mma_3xtf32<NT, kExactX>(acc, ab, as, bb, bs);
      }
    }

    T* yb = static_cast<T*>(a.y) + (((long long)b * a.L + c0) * a.H + h) * DH + 2 * t;
    const long long row = (long long)a.H * DH;  // y is contiguous
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (r0 < Q) store2(yb + r0 * row + 8 * n, acc[n][0], acc[n][1]);
      if (r1 < Q) store2(yb + r1 * row + 8 * n, acc[n][2], acc[n][3]);
    }
  }
}

// ------------------------------- launch -------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;  // the attribute is set once per instantiation
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  done = err == cudaSuccess;
  return err;
}

template <typename T, int N, int DH>
cudaError_t launch_typed(const Args& a, int Bt, cudaStream_t stream) {
  static bool state_ok = false, scan_ok = false;
  const size_t state_smem = StateSmem<T, N, DH>::kBytes, scan_smem = ScanSmem<T, N, DH>::kBytes;
  cudaError_t err = allow_smem(ssd_chunk_state<T, N, DH>, state_smem, state_ok);
  if (err != cudaSuccess) return err;
  err = allow_smem(ssd_chunk_scan<T, N, DH>, scan_smem, scan_ok);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.nc, Bt, (a.H + a.TH - 1) / a.TH);
  ssd_chunk_state<T, N, DH><<<grid, kThreads, state_smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long threads = (long long)Bt * a.H * N * DH / 4;
  ssd_state_pass<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(a, Bt, N * DH);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_chunk_scan<T, N, DH><<<grid, kThreads, scan_smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t launch_dh(int DH, const Args& a, int Bt, cudaStream_t stream) {
  switch (DH) {
    case 16: return launch_typed<T, N, 16>(a, Bt, stream);
    case 32: return launch_typed<T, N, 32>(a, Bt, stream);
    case 64: return launch_typed<T, N, 64>(a, Bt, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_n(int N, int DH, const Args& a, int Bt, cudaStream_t stream) {
  switch (N) {
    case 16: return launch_dh<T, 16>(DH, a, Bt, stream);
    case 64: return launch_dh<T, 64>(DH, a, Bt, stream);
    case 128: return launch_dh<T, 128>(DH, a, Bt, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (Bt, L, H, dh) with the strides given (elements; dh contiguous), dt
// (Bt, L, H) and A (H,) f32 with the strides given, B and C (Bt, L, N) f32
// with the strides given (N contiguous); x's, B's and C's rows 16-byte
// aligned.  y (Bt, L, H, dh) contiguous in x's dtype, S_out (Bt, H, N, dh)
// contiguous f32; scratch: states (Bt, L / chunk, H, N, dh) and cs (Bt, H, L),
// f32, contiguous.  dtype: 0 = float32, 1 = bfloat16 (x and y).  N in
// {16, 64, 128}, dh in {16, 32, 64}, 1 <= chunk <= 128 dividing L, 1 <= th <= H
// heads per block.  Launches three kernels on the stream; returns a CUDA
// error code (0 when all three launched); does not synchronise.
extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* A, const void* B, const void* C, void* y,
    void* S_out, void* states, void* cs, long long sxb, long long sxl, long long sxh,
    long long sdb, long long sdl, long long sdh, long long sbb, long long sbl, long long scb,
    long long scl, long long sA, int Bt, int L, int H, int dh, int N, int chunk, int th,
    int dtype, void* stream) {
  if (Bt <= 0 || L <= 0 || H <= 0 || chunk <= 0 || chunk > kMaxQ || L % chunk != 0 || th < 1 ||
      th > H)
    return cudaErrorInvalidValue;
  Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A),
         static_cast<const float*>(B), static_cast<const float*>(C), y,
         static_cast<float*>(S_out), static_cast<float*>(states), static_cast<float*>(cs),
         sxb, sxl, sxh, sdb, sdl, sdh, sbb, sbl, scb, scl, sA, H, L, chunk, L / chunk, th};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_n<float>(N, dh, a, Bt, st);
  if (dtype == 1) return launch_n<__nv_bfloat16>(N, dh, a, Bt, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
