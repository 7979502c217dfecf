// paged_attention: decode attention of one new token per sequence over a
// paged KV pool, for Hopper (sm_90a), online softmax in f32.
//
// Replaces the TPU kernel
// src/repro/kernels/paged_attention/kernel.py::_paged_kernel (launched by
// paged_attention_pallas).  Same contract: page p of sequence b is pool
// page clamp(page_table[b, p], 0, N-1); only pages with p*page < length are
// read; positions at or past length score -1e30 (a zero contribution once a
// real score has been seen); the G = H/Hk query heads of a KV head share
// every page they read; a zero denominator becomes 1, so a sequence of
// length 0 gives 0.
//
// The TPU kernel walks the pages of one (b, kv-head) in order, one grid
// step each, with the page table scalar-prefetched so the pipeline can DMA
// the next page while this one computes.  Here one block of 8 warps owns
// (b, kv-head): warp w walks pages w, w+8, w+16, ... with its own (m, l,
// acc), loads 8 tokens' K and V rows before it uses any of them, and the
// warps' partial softmaxes are merged once at the end through shared
// memory.
//
// Lane mapping (struct Lanes): a token row is held by GROUP lanes of E
// elements each, and a warp loads 32 / GROUP tokens at once.
//   * D = 32, 64, 128: E = D/32, one group of 32 lanes; one token row is
//     one coalesced 128-512 byte load per warp (f32).
//   * D = 112: E = 4 (one 16-byte f32 load a lane), 28 lanes hold the row
//     and 4 stay idle (their elements are zero and they store nothing):
//     a 12.5% idle share of the lanes, against a split into 3.5 elements
//     that no vector load takes.
//   * D = 16: E = 4 and groups of 4 lanes, so one warp load covers 8
//     tokens (512 contiguous bytes of a page in f32 when Hk = 1).  Each
//     group keeps its own (m, l, acc) over its tokens; the dot product sums
//     over the group only (shuffles within 4 lanes), and the 8 groups'
//     partial softmaxes join the warps' in the final merge.  One group of
//     32 lanes would leave 28 lanes idle on every load.
//
// What bounds it on this card: each K and V element is read once and used
// for G multiply-adds, so bytes bound it: at Qwen3-0.6B's widths (Hk=8,
// D=128, f32) a 528-token sequence is 4.3 MB of K and V per layer, and
// the least time at 3.35 TB/s is ~1.3 us per sequence.  The design keeps
// 8 pages in flight per (b, kv-head) and many (b, kv-head) blocks per SM.
// With B*Hk blocks only (32 at B=4), a small batch leaves most SMs idle:
// splitting a sequence's pages across blocks (split-K flash-decode) is
// later work.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kChunk = 8;  // tokens whose rows are loaded before any is used
constexpr float kNegInf = -1e30f;

template <int E>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[E]) {
  if constexpr (E == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else if constexpr (E == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  } else {
    x[0] = *p;
  }
}

template <int E>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&x)[E]) {
  if constexpr (E == 1) {
    x[0] = __bfloat162float(*p);
  } else {
#pragma unroll
    for (int e = 0; e < E; e += 2) {
      const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + e));
      x[e] = t.x; x[e + 1] = t.y;
    }
  }
}

__device__ __forceinline__ float to_out(float x, float*) { return x; }
__device__ __forceinline__ __nv_bfloat16 to_out(float x, __nv_bfloat16*) {
  return __float2bfloat16(x);
}

// the sum over the GROUP lanes of a token group (GROUP a power of two)
template <int GROUP>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = GROUP / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// how a warp's lanes hold token rows of D elements (see the header)
template <int D>
struct Lanes {
  static_assert(D == 16 || D == 32 || D == 64 || D == 112 || D == 128, "unsupported head dim");
  static constexpr int E = D % 32 == 0 ? D / 32 : 4;  // elements of a row per lane
  static constexpr int HOLD = D / E;                  // lanes that hold a row
  static constexpr int GROUP = HOLD < 32 && 32 % HOLD == 0 ? HOLD : 32;  // lanes per token
  static constexpr int TPW = 32 / GROUP;              // tokens a warp loads at once
};

template <typename T, int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
             const int* __restrict__ page_table, const int* __restrict__ lengths,
             T* __restrict__ o, int Hk, int N, int page, int P, float scale) {
  constexpr int E = Lanes<D>::E, GROUP = Lanes<D>::GROUP, TPW = Lanes<D>::TPW;
  constexpr int kParts = kWarps * TPW;  // partial softmaxes merged at the end
  __shared__ float sm_m[kParts][G], sm_l[kParts][G];
  __shared__ float sm_acc[kParts][G][D];

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / GROUP, gl = lane % GROUP;  // token group, lane within it
  const bool holds = gl < Lanes<D>::HOLD;
  const int part = warp * TPW + grp;
  const int H = Hk * G;
  const int length = lengths[b];
  const long long tok = static_cast<long long>(Hk) * D;  // between a page's tokens

  float qr[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (holds) {
      load_vec<E>(q + (static_cast<long long>(b) * H + h * G + g) * D + gl * E, qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qr[g][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) qr[g][e] *= scale;
  }
  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  for (int p = warp; p < P && p * page < length; p += kWarps) {
    const int pid = min(max(page_table[static_cast<long long>(b) * P + p], 0), N - 1);
    const long long base = (static_cast<long long>(pid) * page * Hk + h) * D + gl * E;
    const int n = min(page, length - p * page);  // valid tokens of this page
    for (int t0 = 0; t0 < n; t0 += kChunk * TPW) {
      float kr[kChunk][E], vr[kChunk][E];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int t = t0 + u * TPW + grp;  // this group's token
        if (t < n && holds) {
          load_vec<E>(kp + base + t * tok, kr[u]);
          load_vec<E>(vp + base + t * tok, vr[u]);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) kr[u][e] = vr[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s[kChunk];
        float mx = kNegInf;
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) dot = fmaf(qr[g][e], kr[u][e], dot);
          dot = group_sum<GROUP>(dot);
          s[u] = t0 + u * TPW + grp < n ? dot : kNegInf;
          mx = fmaxf(mx, s[u]);
        }
        const float m_new = fmaxf(m[g], mx);
        const float alpha = expf(m[g] - m_new);
        float rs = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const float pu = expf(s[u] - m_new);
          rs += pu;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pu, vr[u][e], acc[g][e]);
        }
        l[g] = l[g] * alpha + rs;
        m[g] = m_new;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (holds) {
#pragma unroll
      for (int e = 0; e < E; ++e) sm_acc[part][g][gl * E + e] = acc[g][e];
    }
    if (gl == 0) {
      sm_m[part][g] = m[g];
      sm_l[part][g] = l[g];
    }
  }
  __syncthreads();

  // merge the partial softmaxes of the warps (and of their token groups)
  for (int idx = threadIdx.x; idx < G * D; idx += kWarps * 32) {
    const int g = idx / D, d = idx % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kParts; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kParts; ++w) {
      const float f = expf(sm_m[w][g] - M);
      L = fmaf(sm_l[w][g], f, L);
      A = fmaf(sm_acc[w][g][d], f, A);
    }
    const float denom = L == 0.f ? 1.f : L;
    o[(static_cast<long long>(b) * H + h * G + g) * D + d] =
        to_out(A / denom, static_cast<T*>(nullptr));
  }
}

template <typename T, int D, int G>
cudaError_t launch_typed(const void* q, const void* kp, const void* vp, const int* pt,
                         const int* lengths, void* o, int B, int Hk, int N, int page, int P,
                         float scale, cudaStream_t stream) {
  paged_decode<T, D, G><<<dim3(Hk, B), kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), pt,
      lengths, static_cast<T*>(o), Hk, N, page, P, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_group(int G, const void* q, const void* kp, const void* vp, const int* pt,
                         const int* lengths, void* o, int B, int Hk, int N, int page, int P,
                         float scale, cudaStream_t stream) {
  switch (G) {
    case 1: return launch_typed<T, D, 1>(q, kp, vp, pt, lengths, o, B, Hk, N, page, P, scale, stream);
    case 2: return launch_typed<T, D, 2>(q, kp, vp, pt, lengths, o, B, Hk, N, page, P, scale, stream);
    case 4: return launch_typed<T, D, 4>(q, kp, vp, pt, lengths, o, B, Hk, N, page, P, scale, stream);
    case 8: return launch_typed<T, D, 8>(q, kp, vp, pt, lengths, o, B, Hk, N, page, P, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_dim(int D, int G, const void* q, const void* kp, const void* vp,
                       const int* pt, const int* lengths, void* o, int B, int Hk, int N,
                       int page, int P, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_group<T, 16>(G, q, kp, vp, pt, lengths, o, B, Hk, N, page, P, scale, stream);
    case 32: return launch_group<T, 32>(G, q, kp, vp, pt, lengths, o, B, Hk, N, page, P, scale, stream);
    case 64: return launch_group<T, 64>(G, q, kp, vp, pt, lengths, o, B, Hk, N, page, P, scale, stream);
    case 112: return launch_group<T, 112>(G, q, kp, vp, pt, lengths, o, B, Hk, N, page, P, scale, stream);
    case 128: return launch_group<T, 128>(G, q, kp, vp, pt, lengths, o, B, Hk, N, page, P, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, D), k_pages and v_pages (N, page, Hk, D), o (B, H, D), all
// contiguous with 16-byte aligned bases; page_table (B, P) and lengths (B,)
// int32.  dtype: 0 = float32, 1 = bfloat16 (q, the pools and o).  Returns a
// CUDA error code (0 on a clean launch); does not synchronise.
extern "C" int paged_attention_launch(const void* q, const void* k_pages, const void* v_pages,
                                      const void* page_table, const void* lengths, void* o,
                                      int B, int H, int Hk, int D, int N, int page, int P,
                                      float scale, int dtype, void* stream) {
  if (B <= 0 || Hk <= 0 || H % Hk != 0 || N <= 0 || page <= 0 || P < 0)
    return cudaErrorInvalidValue;
  const int G = H / Hk;
  auto st = static_cast<cudaStream_t>(stream);
  auto pt = static_cast<const int*>(page_table);
  auto ln = static_cast<const int*>(lengths);
  if (dtype == 0)
    return launch_dim<float>(D, G, q, k_pages, v_pages, pt, ln, o, B, Hk, N, page, P, scale, st);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(D, G, q, k_pages, v_pages, pt, ln, o, B, Hk, N, page, P,
                                     scale, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
