// flash_attention: GQA forward attention (causal or full) for Hopper
// (sm_90a), its products on the tensor cores, the online softmax in f32.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/kernel.py::_flash_fwd_kernel
// (launched by flash_attention_pallas).  Same contract: query head h reads
// KV head h / G; causal queries are aligned to the end of the keys
// (q_offset = Lk - Lq), so query row r sees keys <= q_offset + r; masked
// scores are -1e30 (not -inf); the running max starts at -1e30; a zero
// denominator becomes 1; key tiles wholly above the diagonal are skipped;
// the output has the inputs' dtype (f32 or bf16), the softmax is f32.
//
// The TPU kernel runs its grid (B, H, q-blocks, k-blocks) in order on one
// core and carries (m, l, acc) across k-blocks in VMEM scratch.  Here one
// block of four warps owns (b, h, a tile of 64 query rows) and loops over
// tiles of 64 keys itself; each warp owns 16 query rows, with (m, l, acc)
// in registers.  Tile sizes are the card's, not the caller's
// block_q/block_k: only the order of the sums differs.  Causal blocks are
// issued longest first (the last query tile sees the most keys).
//
// Products on mma.sync (mma_tf32x3.cuh):
//   f32 inputs:  S = Q K^T and O += P V in 3xTF32 on m16n8k8, f32 accuracy
//                (each operand split into two TF32 parts, three products);
//   bf16 inputs: S = Q K^T on m16n8k16 in bf16 (its products exact in f32);
//                O += P V with P split into bf16 hi + lo, two products, so P
//                keeps ~16 bits (V is exact in bf16).
// P comes out of S's accumulators in the C-fragment layout.  For bf16 that
// is m16n8k16's A layout as it stands; for TF32 the product takes k-slot t
// for key 2t and t + 4 for key 2t + 1 and reads V's rows in that order, so
// no shuffle is needed.  In Q K^T each thread's two d's are adjacent, so
// they load as one float2.  Q is copied once, K and V tiles with cp.async: K of
// the next tile lands while the softmax runs, V of the next tile while the
// next Q K^T runs.  Rows are padded so each fragment load hits 32 distinct
// banks.
//
// Head dims: 16, 32, 64, 112 and 128.  Each is a multiple of the TF32
// k-step (8) and the bf16 one (16), its rows are multiples of the 16 bytes a
// cp.async moves, and D % 16 == 0 keeps the padded strides conflict-free:
// (D + 8) words per Q/K row put the float2 loads of a half-warp's rows g at
// banks 8g or 24g (mod 32), (D + 4) per V row puts rows 2t at banks 8t.
//
// What bounds it on this card: at the serve shape (B=4, H=16, L=512,
// D=128, causal) the work is ~4.3 GFLOP against ~50 MB of q, k, v and o, so
// operations bound it: ~0.064 ms at the f32 FMA peak of 67 TFLOP/s; 3xTF32
// issues three TF32 products for each, 12.9 GFLOP at 495 TFLOP/s, ~0.026 ms.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_tf32x3.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block: 4 warps x 16
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;
constexpr int kKT = kBK / 8;   // key n-tiles of S
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, h, l;  // in elements; the last dim is contiguous
};

using bf16 = __nv_bfloat16;

// Row strides in shared memory, padded so each fragment load hits 32
// distinct banks: Q and K rows + 8 (f32: float2 loads at 8g + 2t; bf16:
// words 4g + t); V rows + 4 in f32 (rows 2t and 2t + 1: banks 8t + g),
// + 8 in bf16.
template <typename T, int D>
struct Row {
  static constexpr int kQK = D + 8;
  static constexpr int kV = sizeof(T) == 4 ? D + 4 : D + 8;
};

// s[j] (16 rows x keys 8j..8j+7) = Q K^T over d, for this warp's rows.
// TF32: k-slot t takes d = k0 + 2t and t + 4 takes k0 + 2t + 1 in both
// operands (any order of d gives the same sum), so each thread reads its
// two values as one float2.
template <int D>
__device__ __forceinline__ void qk(float (&s)[kKT][4], const float* Qw, const float* Ks, int g,
                                   int t) {
  constexpr int L = Row<float, D>::kQK;
#pragma unroll 2
  for (int k0 = 0; k0 < D; k0 += 8) {
    const float2 qa = *reinterpret_cast<const float2*>(Qw + g * L + k0 + 2 * t);
    const float2 qb = *reinterpret_cast<const float2*>(Qw + (g + 8) * L + k0 + 2 * t);
    const float av[4] = {qa.x, qb.x, qa.y, qb.y};
    uint32_t ab[4], as[4];
    tc::split(av, ab, as);
    uint32_t bb[kKT][2], bs[kKT][2];
#pragma unroll
    for (int j = 0; j < kKT; ++j) {
      const float2 kv = *reinterpret_cast<const float2*>(Ks + (8 * j + g) * L + k0 + 2 * t);
      tc::split(kv.x, bb[j][0], bs[j][0]);
      tc::split(kv.y, bb[j][1], bs[j][1]);
    }
    tc::mma_3xtf32<kKT>(s, ab, as, bb, bs);
  }
}

template <int D>
__device__ __forceinline__ void qk(float (&s)[kKT][4], const bf16* Qw, const bf16* Ks, int g,
                                   int t) {
  constexpr int L = Row<bf16, D>::kQK;
#pragma unroll 2
  for (int k0 = 0; k0 < D; k0 += 16) {
    const bf16* q0 = Qw + g * L + k0 + 2 * t;
    const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(q0),
                           *reinterpret_cast<const uint32_t*>(q0 + 8 * L),
                           *reinterpret_cast<const uint32_t*>(q0 + 8),
                           *reinterpret_cast<const uint32_t*>(q0 + 8 * L + 8)};
#pragma unroll
    for (int j = 0; j < kKT; ++j) {
      const bf16* k = Ks + (8 * j + g) * L + k0 + 2 * t;
      const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(k),
                             *reinterpret_cast<const uint32_t*>(k + 8)};
      tc::mma_bf16(s[j], a, b);
    }
  }
}

// o (16 rows x d 8n..8n+7) += P V over this tile's keys
template <int D>
__device__ __forceinline__ void pv(float (&o)[D / 8][4], const float (&p)[kKT][4],
                                   const float* Vs, int g, int t) {
  constexpr int L = Row<float, D>::kV;
#pragma unroll
  for (int j = 0; j < kKT; ++j) {
    // A: k-slot t is key 8j + 2t, k-slot t + 4 is key 8j + 2t + 1
    const float av[4] = {p[j][0], p[j][2], p[j][1], p[j][3]};
    uint32_t ab[4], as[4];
    tc::split(av, ab, as);
    const float* v = Vs + (8 * j + 2 * t) * L + g;
    uint32_t bb[D / 8][2], bs[D / 8][2];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      tc::split(v[8 * n], bb[n][0], bs[n][0]);
      tc::split(v[L + 8 * n], bb[n][1], bs[n][1]);
    }
    tc::mma_3xtf32<D / 8>(o, ab, as, bb, bs);
  }
}

template <int D>
__device__ __forceinline__ void pv(float (&o)[D / 8][4], const float (&p)[kKT][4],
                                   const bf16* Vs, int g, int t) {
  constexpr int L = Row<bf16, D>::kV;
#pragma unroll
  for (int kk = 0; kk < kKT / 2; ++kk) {  // 16 keys: S n-tiles 2kk and 2kk + 1
    const float* p0 = p[2 * kk];
    const float* p1 = p[2 * kk + 1];
    const float hv[8] = {p0[0], p0[1], p0[2], p0[3], p1[0], p1[1], p1[2], p1[3]};
    float lv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) lv[i] = hv[i] - __bfloat162float(__float2bfloat16_rn(hv[i]));
    const uint32_t ah[4] = {tc::pack_bf16(hv[0], hv[1]), tc::pack_bf16(hv[2], hv[3]),
                            tc::pack_bf16(hv[4], hv[5]), tc::pack_bf16(hv[6], hv[7])};
    const uint32_t al[4] = {tc::pack_bf16(lv[0], lv[1]), tc::pack_bf16(lv[2], lv[3]),
                            tc::pack_bf16(lv[4], lv[5]), tc::pack_bf16(lv[6], lv[7])};
    const bf16* v = Vs + (16 * kk + 2 * t) * L + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const bf16* vn = v + 8 * n;
      const uint32_t b[2] = {tc::pack_bf16(vn[0], vn[L]), tc::pack_bf16(vn[8 * L], vn[9 * L])};
      tc::mma_bf16(o[n], al, b);
      tc::mma_bf16(o[n], ah, b);
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, Strides sq, Strides sk, Strides sv, Strides so, int G, int Lq,
          int Lk, int causal, int q_offset, float scale) {
  static_assert(D % 16 == 0 && D <= 128, "head dims are multiples of 16 up to 128");
  constexpr int L = Row<T, D>::kQK, LV = Row<T, D>::kV;
  constexpr int NO = D / 8;  // output n-tiles
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);  // [kBQ][L]
  T* Ks = Qs + kBQ * L;                 // [kBK][L]
  T* Vs = Ks + kBK * L;                 // [kBK][LV]

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + (h / G) * sk.h;
  const T* vb = v + b * sv.b + (h / G) * sv.h;
  T* ob = o + b * so.b + h * so.h;

  int n_tiles = (Lk + kBK - 1) / kBK;
  if (causal) {  // skip key tiles wholly above the diagonal
    const int last_row = q_offset + min(q0 + kBQ, Lq) - 1;
    n_tiles = last_row < 0 ? 0 : min(n_tiles, last_row / kBK + 1);
  }

  tc::load_rows_async(Qs, L, qb + q0 * sq.l, sq.l, D, kBQ, Lq - q0);
  if (n_tiles > 0) tc::load_rows_async(Ks, L, kb, sk.l, D, kBK, Lk);
  tc::cp_async_commit();
  if (n_tiles > 0) tc::load_rows_async(Vs, LV, vb, sv.l, D, kBK, Lk);
  tc::cp_async_commit();

  // this thread's rows: g and g + 8 of the warp's 16
  const int row0 = q_offset + q0 + warp * 16 + g, row1 = row0 + 8;
  const float scale_log2 = scale * kLog2e;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBK;
    tc::cp_async_wait<1>();  // Q and this tile's K have landed; V may fly
    __syncthreads();
    float s[kKT][4];
#pragma unroll
    for (int j = 0; j < kKT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    qk<D>(s, Qs + warp * 16 * L, Ks, g, t);
    __syncthreads();  // every warp is done with K
    if (tile + 1 < n_tiles)
      tc::load_rows_async(Ks, L, kb + (k0 + kBK) * sk.l, sk.l, D, kBK, Lk - k0 - kBK);
    tc::cp_async_commit();

    // scores in log2 units: exp(x) = exp2(x log2(e)), one multiply folded
    // into the scale, and exp2f is a single hardware op
    const bool edge = k0 + kBK > Lk || (causal && k0 + kBK - 1 > q_offset + q0);
#pragma unroll
    for (int j = 0; j < kKT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= scale_log2;
        if (edge) {
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          const int row = e < 2 ? row0 : row1;
          if (col >= Lk || (causal && col > row)) s[j][e] = kNegInf;
        }
      }
    }

    // online softmax; the four threads of a quad share rows g and g + 8
    float mx0 = s[0][0], mx1 = s[0][2];
#pragma unroll
    for (int j = 0; j < kKT; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kKT; ++j) {
      s[j][0] = exp2f(s[j][0] - mn0);
      s[j][1] = exp2f(s[j][1] - mn0);
      s[j][2] = exp2f(s[j][2] - mn1);
      s[j][3] = exp2f(s[j][3] - mn1);
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
    l0 = l0 * al0 + quad_sum(rs0);
    l1 = l1 * al1 + quad_sum(rs1);
    m0 = mn0;
    m1 = mn1;

    // P V of this tile in accumulators of its own, then added to the
    // running sum by f32 FMAs, which round to nearest.  The tensor core
    // does not round its sums to nearest: a running sum carried through
    // every tile's products drifted with the number of tiles (2e-5 at row
    // 32,768 of Qwen3-0.6B's first layer against an f64 reference, where a
    // plain f32 sum is within 1e-7).
    float pacc[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n) pacc[n][0] = pacc[n][1] = pacc[n][2] = pacc[n][3] = 0.f;
    tc::cp_async_wait<1>();  // this tile's V has landed; the next K may fly
    __syncthreads();
    pv<D>(pacc, s, Vs, g, t);
    __syncthreads();  // every warp is done with V
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] = fmaf(acc[n][0], al0, pacc[n][0]);
      acc[n][1] = fmaf(acc[n][1], al0, pacc[n][1]);
      acc[n][2] = fmaf(acc[n][2], al1, pacc[n][2]);
      acc[n][3] = fmaf(acc[n][3], al1, pacc[n][3]);
    }
    if (tile + 1 < n_tiles)
      tc::load_rows_async(Vs, LV, vb + (k0 + kBK) * sv.l, sv.l, D, kBK, Lk - k0 - kBK);
    tc::cp_async_commit();
  }

  tc::cp_async_wait<0>();  // nothing is left in flight when the block exits
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float d0 = l0 == 0.f ? 1.f : l0, d1 = l1 == 0.f ? 1.f : l1;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (r0 < Lq) store2(ob + r0 * so.l + 8 * n + 2 * t, acc[n][0] / d0, acc[n][1] / d0);
    if (r1 < Lq) store2(ob + r1 * so.l + 8 * n + 2 * t, acc[n][2] / d1, acc[n][3] / d1);
  }
}

template <typename T, int D>
cudaError_t launch_typed(const void* q, const void* k, const void* v, void* o, Strides sq,
                         Strides sk, Strides sv, Strides so, int B, int H, int G, int Lq,
                         int Lk, int causal, float scale, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(T)) *
                   ((kBQ + kBK) * Row<T, D>::kQK + kBK * Row<T, D>::kV);
  static bool configured = false;  // the attribute is set once per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
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
    case 16:
      return launch_typed<T, 16>(q, k, v, o, sq, sk, sv, so, B, H, G, Lq, Lk, causal, scale, stream);
    case 32:
      return launch_typed<T, 32>(q, k, v, o, sq, sk, sv, so, B, H, G, Lq, Lk, causal, scale, stream);
    case 64:
      return launch_typed<T, 64>(q, k, v, o, sq, sk, sv, so, B, H, G, Lq, Lk, causal, scale, stream);
    case 112:
      return launch_typed<T, 112>(q, k, v, o, sq, sk, sv, so, B, H, G, Lq, Lk, causal, scale, stream);
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
    return launch_dim<bf16>(D, q, k, v, o, sq, sk, sv, so, B, H, G, Lq, Lk, causal, scale, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
