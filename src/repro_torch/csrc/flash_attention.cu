// flash_attention: GQA forward attention (causal or full) for Hopper
// (sm_90a), online softmax in f32 on the CUDA cores.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/kernel.py::_flash_fwd_kernel
// (launched by flash_attention_pallas).  Same contract: query head h reads
// KV head h / G; causal queries are aligned to the end of the keys
// (q_offset = Lk - Lq), so query row r sees keys <= q_offset + r; masked
// scores are -1e30 (not -inf); the running max starts at -1e30; a zero
// denominator becomes 1; key tiles wholly above the diagonal are skipped;
// the output has the inputs' dtype (f32 or bf16), the arithmetic is f32.
//
// The TPU kernel runs its grid (B, H, q-blocks, k-blocks) in order on one
// core and carries (m, l, acc) across k-blocks in VMEM scratch.  Here one
// block of 128 threads owns (b, h, a tile of 64 query rows) and loops over
// tiles of 64 keys itself, with (m, l, acc) in registers.  Tile sizes are
// the card's, not the caller's block_q/block_k: only the order of the sums
// differs.
//
// What bounds it on this card: at the serve shape (B=4, H=16, L=512,
// D=128, causal) the work is ~4.3 GFLOP against ~50 MB of q, k, v and o,
// so operations bound it: at the f32 (non-tensor) peak of 67 TFLOP/s the
// least time is ~0.064 ms.  The design keeps the FMA units fed from
// shared memory: Q^T and K^T tiles are staged transposed so each thread
// reads float4s of 4 query rows and 2x4 key columns per step of d and does
// 32 FMAs, and the 4x(D/8) output micro-tile stays in registers across
// key tiles.  The P tile reuses the K^T buffer, so D=128 takes ~100 KB of
// shared memory and two blocks fit on an SM.  Tensor cores (wgmma), TMA
// and a pipelined tile ring are later work.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 128;    // 16 row groups x 8 column groups
constexpr int kLd = kBQ + 4;     // row stride of the transposed tiles; keeps float4 alignment
constexpr float kNegInf = -1e30f;

static_assert(kBQ == kBK, "Qt, Kt and Pt share the row stride kLd");

struct Strides {
  long long b, h, l;  // in elements; the last dim is contiguous
};

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + 2));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&x)[4]) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x[0], x[1]);
  *reinterpret_cast<__nv_bfloat162*>(p + 2) = __floats2bfloat162_rn(x[2], x[3]);
}

__device__ __forceinline__ float group8_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float group8_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// Stage rows [r0, r0 + kBQ) of a (rows, D) matrix transposed into
// dst[d * kLd + r], times `mul`; rows at or past n become zeros.  Adjacent
// threads take adjacent rows, so the shared-memory stores do not conflict.
template <typename T, int D>
__device__ __forceinline__ void stage_transposed(float* dst, const T* src, long long ld,
                                                 int r0, int n, float mul) {
  for (int idx = threadIdx.x; idx < kBQ * (D / 4); idx += kThreads) {
    const int r = idx % kBQ, d4 = idx / kBQ;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < n) load4(src + (r0 + r) * ld + d4 * 4, x);
#pragma unroll
    for (int c = 0; c < 4; ++c) dst[(d4 * 4 + c) * kLd + r] = x[c] * mul;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, Strides sq, Strides sk, Strides sv, Strides so, int G, int Lq,
          int Lk, int causal, int q_offset, float scale) {
  constexpr int kOC = D / 8;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);     // [D][kLd]   q^T * scale
  float* Kt = Qt + D * kLd;                         // [D][kLd]   k^T; then p^T [kBK][kLd]
  float* Pt = Kt;
  float* Vs = Kt + (D > kBK ? D : kBK) * kLd;       // [kBK][D]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + (h / G) * sk.h;
  const T* vb = v + b * sv.b + (h / G) * sv.h;
  T* ob = o + b * so.b + h * so.h;

  stage_transposed<T, D>(Qt, qb, sq.l, q0, Lq, scale);

  float m[4], l[4], acc[4][kOC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOC; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (Lk + kBK - 1) / kBK;
  if (causal) {  // skip key tiles wholly above the diagonal
    const int last_row = q_offset + min(q0 + kBQ, Lq) - 1;
    n_tiles = last_row < 0 ? 0 : min(n_tiles, last_row / kBK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile is done with Pt (= Kt) and Vs
    stage_transposed<T, D>(Kt, kb, sk.l, k0, Lk, 1.f);
    for (int idx = tid; idx < kBK * (D / 4); idx += kThreads) {
      const int r = idx / (D / 4), d4 = idx % (D / 4);
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + r < Lk) load4(vb + (k0 + r) * sv.l + d4 * 4, x);
      *reinterpret_cast<float4*>(&Vs[r * D + d4 * 4]) = make_float4(x[0], x[1], x[2], x[3]);
    }
    __syncthreads();

    // S = (q * scale) k^T on rows ty*4+i, columns tx*4 + 32*(j/4) + j%4
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * kLd + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Kt[d * kLd + tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Kt[d * kLd + tx * 4 + 32]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    const bool edge = k0 + kBK > Lk || (causal && k0 + kBK - 1 > q_offset + q0);
    if (edge) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q_offset + q0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = k0 + tx * 4 + (j / 4) * 32 + (j % 4);
          if (col >= Lk || (causal && col > row)) s[i][j] = kNegInf;
        }
      }
    }

    // online softmax; the 8 threads of a row group are adjacent lanes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) mx = fmaxf(mx, s[i][j]);
      const float m_new = fmaxf(m[i], group8_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + group8_sum(rs);
#pragma unroll
      for (int c = 0; c < kOC; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }

    __syncthreads();  // every thread is done reading Kt before Pt overwrites it
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tx * 4 + (j / 4) * 32 + (j % 4);
      *reinterpret_cast<float4*>(&Pt[col * kLd + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    // acc += P V on output columns tx*4 + 32*jj + c
    const int kmax = min(kBK, Lk - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(&Pt[kk * kLd + ty * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int jj = 0; jj < D / 32; ++jj) {
        const float4 w = *reinterpret_cast<const float4*>(&Vs[kk * D + tx * 4 + jj * 32]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][jj * 4 + 0] = fmaf(pv[i], w.x, acc[i][jj * 4 + 0]);
          acc[i][jj * 4 + 1] = fmaf(pv[i], w.y, acc[i][jj * 4 + 1]);
          acc[i][jj * 4 + 2] = fmaf(pv[i], w.z, acc[i][jj * 4 + 2]);
          acc[i][jj * 4 + 3] = fmaf(pv[i], w.w, acc[i][jj * 4 + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Lq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int jj = 0; jj < D / 32; ++jj) {
      float out[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) out[c] = acc[i][jj * 4 + c] / denom;
      store4(ob + row * so.l + tx * 4 + jj * 32, out);
    }
  }
}

template <typename T, int D>
cudaError_t launch_typed(const void* q, const void* k, const void* v, void* o, Strides sq,
                         Strides sk, Strides sv, Strides so, int B, int H, int G, int Lq,
                         int Lk, int causal, float scale, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) *
                   (D * kLd + (D > kBK ? D : kBK) * kLd + kBK * D);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  const int q_offset = causal ? Lk - Lq : 0;
  flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, sv, so, G, Lq, Lk, causal, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int D, const void* q, const void* k, const void* v, void* o,
                       Strides sq, Strides sk, Strides sv, Strides so, int B, int H, int G,
                       int Lq, int Lk, int causal, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_typed<T, 32>(q, k, v, o, sq, sk, sv, so, B, H, G, Lq, Lk, causal, scale, stream);
    case 64:
      return launch_typed<T, 64>(q, k, v, o, sq, sk, sv, so, B, H, G, Lq, Lk, causal, scale, stream);
    case 128:
      return launch_typed<T, 128>(q, k, v, o, sq, sk, sv, so, B, H, G, Lq, Lk, causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Lq, D), k and v (B, Hk, Lk, D), o (B, H, Lq, D), each with the
// strides given (elements; the last dim contiguous, 16-byte aligned rows).
// dtype: 0 = float32, 1 = bfloat16 (all four tensors).  Returns a CUDA error
// code (0 on a clean launch); does not synchronise.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o,
    long long sqb, long long sqh, long long sql, long long skb, long long skh, long long skl,
    long long svb, long long svh, long long svl, long long sob, long long soh, long long sol,
    int B, int H, int Hk, int Lq, int Lk, int D, int causal, float scale, int dtype,
    void* stream) {
  if (B <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0 || Lq <= 0 || Lk <= 0)
    return cudaErrorInvalidValue;
  const Strides sq{sqb, sqh, sql}, sk{skb, skh, skl}, sv{svb, svh, svl}, so{sob, soh, sol};
  auto st = static_cast<cudaStream_t>(stream);
  const int G = H / Hk;
  if (dtype == 0)
    return launch_dim<float>(D, q, k, v, o, sq, sk, sv, so, B, H, G, Lq, Lk, causal, scale, st);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(D, q, k, v, o, sq, sk, sv, so, B, H, G, Lq, Lk, causal,
                                     scale, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
