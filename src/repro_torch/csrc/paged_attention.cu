// paged_attention: decode attention of one new token per sequence over a
// paged KV pool, for Hopper (sm_90a), as a split-K flash-decode: online
// softmax in f32, each sequence's pages split across blocks, pages streamed
// through a ring of shared-memory stages by bulk copies (1-D TMA).
//
// Replaces the TPU kernel
// src/repro/kernels/paged_attention/kernel.py::_paged_kernel (launched by
// paged_attention_pallas).  Same contract: page p of sequence b is pool
// page clamp(page_table[b, p], 0, N-1); only pages with p*page < length are
// read; positions at or past length take no part in the softmax (the TPU
// kernel scores them -1e30, which gives them weight 0 once a real score has
// been seen, and every split here has one); the G = H/Hk query heads of a
// KV head share every page they read; a zero denominator becomes 1, so a
// sequence of length 0 gives 0.  Any G with H % Hk == 0 up to kMaxG.
//
// What bounds it: bytes.  Each K and V element of the valid pages is read
// once and used for 2*G flops (a multiply-add in q.k and one in p.v), so at
// G <= 8 the kernel does <= 4 flops per f32 byte, against the card's f32
// ridge of 67 TFLOP/s / 3.35 TB/s = 20 flops per byte: every supported
// shape is bound by its bytes at 3.35 TB/s.  At Qwen3-0.6B's widths (Hk 8,
// D 128, f32) four sequences of 512-528 tokens are 17 MB, 5.1 us; one
// sequence of 8,192 tokens is 67 MB, 20 us.  The tensor cores would not
// help: the products are G x D by D x tokens with G <= 16.
//
// Two kernels a call (the profiler's names both contain "paged_decode"):
//   * paged_decode_split, grid (Hk, B, S): block (h, b, s) owns page slots
//     [s*ceil(P/S), (s+1)*ceil(P/S)) of sequence b, cut at its last valid
//     page.  The wrapper picks S from B*Hk, P and the SM count (~2 blocks
//     per SM in one wave, at most P, and no split over kMaxSplitPages
//     slots) and never reads lengths or the page table on the host.  A
//     split with no valid page exits at once.  The block writes its partial
//     (m, l, acc[G][D]) in f32 to a workspace the wrapper allocates; with
//     S = 1 it writes the output itself and the merge is not launched.
//   * paged_decode_merge, grid (Hk, B): M = max m_s, L = sum l_s e^(m_s-M),
//     A = sum acc_s e^(m_s-M), o = A / (L == 0 ? 1 : L).
//
// A split block is 3 consumer warps and 1 producer warp over a ring of 3
// stages of 32 tokens (K rows, then V rows); stage i is warp i % 3's, in
// slot i % 3.  The block first reads its page ids (clamped), q (scaled, f32)
// and the length together.  The producer then waits for a slot's "empty"
// mbarrier, posts the stage's bytes on its "full" one, and lane t issues
// the bulk copies (1-D TMA) of token t's K and V rows, D * elem bytes each
// (a multiple of 16 for every supported D and dtype), to a padded address:
// a row stride of D * elem + 16 bytes, an odd multiple of 16, so that the
// score loop reads 8 rows per 128-byte wavefront with no bank conflict.  A
// consumer warp takes its stage whole, with no block barrier: lane t scores
// token t against every head (q read from shared memory by broadcast, each
// K chunk once for all heads); an online softmax per head over the warp
// (shuffles; m and l in registers); then p.V with lane (tg, c) on the
// 4-element chunk c of its token group's tokens (all 32 lanes busy for D <
// 128 too), acc[G][4] in registers.  At the end the warps' partials are
// merged through the ring.  The kernel is templated on GB, G rounded up to
// a power of two (heads past G read a zero q row and are never written), so
// the head loops unroll with no branch; acc is 4 * GB floats a lane.
//
// What holds it, from the card (benchmarks/torch/paged_decode_variants.py
// times the alternatives): at B 4 (S 8) a block's ~80 tokens stream at the
// SM's share of HBM, and the call is held by fixed costs: the block's first
// page-id load, the last stage's arithmetic after its data lands, and the
// merge kernel.  16-byte cp.async copies by the producer's lanes instead of
// one bulk copy a row, and 2 or 4 consumer warps and ring stages instead of
// 3, were no faster.
//
// What the earlier design lost: one block of 8 warps per (b, h), so
// 32 blocks on 132 SMs at B 4, Hk 8 (8 at B 1); each warp loaded 8 tokens'
// rows into registers and only then computed, so no load was in flight
// during the math; and K, V, q and acc rows per thread took 255 registers
// and spilled at G 8.  It ran at 27% of its bytes bound at Qwen's widths,
// 10% at kimi's heads (G 8, D 112) and 10% at one sequence of 8,192 tokens.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTok = 32;            // tokens a stage: one a lane in the score step
constexpr int kWarps = 3;           // consumer warps, each on a stage of its own
constexpr int kStages = kWarps;     // ring slots: slot w is warp w's
constexpr int kConsumers = kWarps * 32;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kMaxG = 16;           // query heads per KV head
constexpr int kMaxSplitPages = 256; // page ids of one split held in shared memory
constexpr int kMergeThreads = 256;
constexpr float kNegInf = -1e30f;

// ---- PTX: mbarriers and bulk copies ----------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}" ::"r"(smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory with the bulk-copy engine (1-D TMA); completion
// is counted in bytes on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the consumer warps only (the producer warp has left)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// ---- element types ---------------------------------------------------------

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// 16 bytes of a row in shared memory, widened to f32
__device__ __forceinline__ void load_chunk(const unsigned char* p, float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}

// bf16 to f32 is exact: the 16 bits are the top half of the f32 (the
// element at the lower address is the low half of each word)
__device__ __forceinline__ void load_chunk(const unsigned char* p, float (&x)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  x[0] = __uint_as_float(t.x << 16); x[1] = __uint_as_float(t.x & 0xffff0000u);
  x[2] = __uint_as_float(t.y << 16); x[3] = __uint_as_float(t.y & 0xffff0000u);
  x[4] = __uint_as_float(t.z << 16); x[5] = __uint_as_float(t.z & 0xffff0000u);
  x[6] = __uint_as_float(t.w << 16); x[7] = __uint_as_float(t.w & 0xffff0000u);
}

// 4 elements of a row in shared memory (16 or 8 bytes), widened to f32
__device__ __forceinline__ void load4(const unsigned char* p, float (&x)[4], float*) {
  load_chunk(p, x);
}

__device__ __forceinline__ void load4(const unsigned char* p, float (&x)[4], __nv_bfloat16*) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(t.x << 16); x[1] = __uint_as_float(t.x & 0xffff0000u);
  x[2] = __uint_as_float(t.y << 16); x[3] = __uint_as_float(t.y & 0xffff0000u);
}

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// four f32 values to 4 consecutive outputs
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(bf16_bits(a) | (bf16_bits(b) << 16), bf16_bits(c) | (bf16_bits(d) << 16));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---- shapes ----------------------------------------------------------------

// GB: the group size G rounded up to a power of two (the heads a warp
// keeps in registers; heads G..GB-1 are masked)
template <typename T, int D, int GB>
struct Shape {
  static_assert(D == 16 || D == 32 || D == 64 || D == 112 || D == 128, "unsupported head dim");
  static_assert(GB == 1 || GB == 2 || GB == 4 || GB == 8 || GB == 16, "unsupported group");
  static constexpr int ELEM = static_cast<int>(sizeof(T));
  static constexpr int VEC = 16 / ELEM;            // elements of a 16-byte chunk
  static constexpr int CH = D / VEC;               // 16-byte chunks a row (score step)
  static constexpr int RS = D * ELEM + 16;         // padded row bytes
  static constexpr int STAGE = 2 * kTok * RS;      // K rows, then V rows
  static constexpr int QS = D + 4;                 // padded q row (f32)
  static constexpr int C4 = D / 4;                 // 4-element chunks a row (p.V step)
  static constexpr int TG = 32 % C4 == 0 ? 32 / C4 : 1;  // token groups of a warp in p.V
  static_assert(D % VEC == 0 && (RS / 16) % 2 == 1, "rows must be odd multiples of 16 bytes");

  // unroll of the score loop: more at few heads, for loads in flight
  static constexpr int UNROLL = GB <= 4 ? 4 : 2;

  // dynamic shared memory: the ring, q (GB rows, those past G zero) and
  // each warp's p[GB][kTok]; the warps' partials are merged in the ring
  // once every stage is read
  static constexpr size_t smem_bytes() {
    return static_cast<size_t>(kStages) * STAGE + sizeof(float) * (GB * QS + kWarps * GB * kTok);
  }
};

// the s-th of S contiguous ranges of ceil(P/S) page slots, cut at the
// sequence's last valid page: its page slots do not depend on the length,
// so a block reads its page ids while it reads the length
struct SplitRange {
  int p0, p1;  // page slots [p0, p1) of the split, before the length cuts them
};

__device__ __forceinline__ SplitRange split_slots(int P, int S, int s) {
  const int per = (P + S - 1) / S;
  return {min(s * per, P), min(s * per + per, P)};
}

// valid tokens: min(max(length, 0), P * page)
__device__ __forceinline__ int valid_tokens(int length, int page, int P) {
  return min(max(length, 0), P * page);
}

// splits that hold a valid page
__device__ __forceinline__ int used_splits(int length, int page, int P, int S) {
  const int per = (P + S - 1) / S;
  const int n = (valid_tokens(length, page, P) + page - 1) / page;
  return per > 0 ? (n + per - 1) / per : 0;
}

// ---- the split kernel ------------------------------------------------------

template <typename T, int D, int GB>
// minBlocks 1 (here and on the merge kernel): without it ptxas spills a
// few bytes in some instantiations while far below the register limit
__global__ void __launch_bounds__(kThreads, 1)
paged_decode_split(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
                   const int* __restrict__ page_table, const int* __restrict__ lengths,
                   T* __restrict__ o, float* __restrict__ ws_acc, float2* __restrict__ ws_ml,
                   int Hk, int G, int N, int page, int P, int S, float scale) {
  using Sh = Shape<T, D, GB>;
  constexpr int VEC = Sh::VEC, RS = Sh::RS, C4 = Sh::C4, TG = Sh::TG;
  constexpr uint32_t kRowBytes = D * sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];
  __shared__ int pids[kMaxSplitPages];

  const int h = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  const int H = Hk * G;
  const int tid = threadIdx.x;
  const long long head0 = static_cast<long long>(b) * H + static_cast<long long>(h) * G;
  const SplitRange rg = split_slots(P, S, s);
  float* qs = reinterpret_cast<float*>(smem + kStages * Sh::STAGE);
  float* ps = qs + GB * Sh::QS;  // [warp][g][t] probabilities

  // the page ids, q and the length are read together (one latency)
  for (int j = tid; j < rg.p1 - rg.p0; j += kThreads)
    pids[j] = min(max(page_table[static_cast<long long>(b) * P + rg.p0 + j], 0), N - 1);
  for (int i = tid; i < GB * D; i += kThreads) {  // heads past G score 0 and are not written
    const int g = i / D;
    qs[g * Sh::QS + (i - g * D)] = g < G ? to_float(q[head0 * D + i]) * scale : 0.f;
  }
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full_bar[i], 1);
      mbar_init(&empty_bar[i], 1);
    }
    mbar_fence_init();
  }
  const int len = valid_tokens(lengths[b], page, P);
  const int t_begin = rg.p0 * page, t_end = min(rg.p1 * page, len);
  __syncthreads();
  if (t_begin >= t_end) {  // no valid page: with S = 1 the output is 0 (length 0)
    if (S == 1) {
      for (int i = tid; i < G * D; i += kThreads) put(o + head0 * D + i, 0.f);
    }
    return;
  }

  const int n_stages = (t_end - t_begin + kTok - 1) / kTok;
  const int warp = tid >> 5, lane = tid & 31;

  if (warp == kWarps) {  // the producer: lane t copies token t's K and V rows
    for (int i = 0; i < n_stages; ++i) {
      const int slot = i % kStages;
      const int n = min(kTok, t_end - t_begin - i * kTok);
      long long off = 0;  // lane t's token row in the pools, in elements
      if (lane < n) {
        const int pos = t_begin + i * kTok + lane;
        const int pg = pos / page;
        off = ((static_cast<long long>(pids[pg - rg.p0]) * page + (pos - pg * page)) * Hk + h) *
              D;
      }
      mbar_wait(&empty_bar[slot], ((i / kStages) & 1) ^ 1);
      if (lane == 0) mbar_arrive_expect_tx(&full_bar[slot], 2u * n * kRowBytes);
      __syncwarp();
      if (lane < n) {
        unsigned char* st = smem + slot * Sh::STAGE;
        bulk_copy(st + lane * RS, kp + off, kRowBytes, &full_bar[slot]);
        bulk_copy(st + (kTok + lane) * RS, vp + off, kRowBytes, &full_bar[slot]);
      }
    }
    return;
  }

  // consumer warp w takes stages w, w + kWarps, ... (all in slot w), each
  // whole: scores with lane t on token t, an online softmax over the warp,
  // p.V with lane (tg, c) on 4-element chunk c of the tokens tg, tg + TG, ...
  float m[GB], l[GB], acc[GB][4];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
  }
  float* pw = ps + warp * GB * kTok;
  const int tg = lane / C4, c4 = lane - (lane / C4) * C4;
  const bool b_on = tg < TG;
  for (int i = warp; i < n_stages; i += kWarps) {
    const int n = min(kTok, t_end - t_begin - i * kTok);
    const unsigned char* kst = smem + warp * Sh::STAGE;
    const unsigned char* vst = kst + kTok * RS;
    mbar_wait(&full_bar[warp], (i / kStages) & 1);

    // scores of token `lane`, two partial sums a head
    const bool valid = lane < n;
    float sa[GB], sb[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) sa[g] = sb[g] = 0.f;
    if (valid) {
#pragma unroll(Sh::UNROLL)
      for (int cc = 0; cc < Sh::CH; ++cc) {
        float kx[VEC];
        load_chunk(kst + lane * RS + cc * 16, kx);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          const float4* qr = reinterpret_cast<const float4*>(qs + g * Sh::QS + cc * VEC);
#pragma unroll
          for (int e = 0; e < VEC / 4; ++e) {
            const float4 qv = qr[e];
            sa[g] = fmaf(qv.x, kx[4 * e], sa[g]);
            sb[g] = fmaf(qv.y, kx[4 * e + 1], sb[g]);
            sa[g] = fmaf(qv.z, kx[4 * e + 2], sa[g]);
            sb[g] = fmaf(qv.w, kx[4 * e + 3], sb[g]);
          }
        }
      }
    }

    // online softmax of each head over the warp's tokens (the GB heads'
    // reductions are independent: no branch between them)
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float x = valid ? sa[g] + sb[g] : kNegInf;
      const float m_new = fmaxf(m[g], warp_max(x));
      const float alpha = expf(m[g] - m_new);
      const float p = valid ? expf(x - m_new) : 0.f;
      l[g] = fmaf(l[g], alpha, warp_sum(p));
      m[g] = m_new;
      pw[g * kTok + lane] = p;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] *= alpha;
    }
    __syncwarp();

    // acc[g][chunk c4] += p[g][u] * V[u][chunk c4], tokens u = tg, tg + TG, ...
    if (b_on) {
#pragma unroll 4
      for (int u = tg; u < n; u += TG) {
        float vx[4];
        load4(vst + u * RS + c4 * 4 * Sh::ELEM, vx, static_cast<T*>(nullptr));
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          const float p = pw[g * kTok + u];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[g][e] = fmaf(p, vx[e], acc[g][e]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_bar[warp]);
  }

  // the token groups of a warp share its softmax: their sums add
  if constexpr (TG > 1) {
#pragma unroll
    for (int off = C4; off < 32; off <<= 1) {
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
    }
  }

  // merge the warps' partials through the ring (every stage has been read)
  consumer_sync();
  float* wacc = reinterpret_cast<float*>(smem);  // [warp][g][D]
  float* wm = wacc + kWarps * G * D;             // [warp][g]
  float* wl = wm + kWarps * G;
  if (b_on && tg == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g)
      if (g < G)
        store4(wacc + (warp * G + g) * D + c4 * 4, acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < G) {
        wm[warp * G + g] = m[g];
        wl[warp * G + g] = l[g];
      }
    }
  }
  consumer_sync();
  const long long split0 = (static_cast<long long>(b) * Hk + h) * S;  // first split's index
  for (int item = tid; item < G * C4; item += kConsumers) {
    const int g = item / C4, c = item - (item / C4) * C4;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w * G + g]);
    float L = 0.f, A[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(wm[w * G + g] - M);
      L = fmaf(wl[w * G + g], f, L);
      const float4 a = *reinterpret_cast<const float4*>(wacc + (w * G + g) * D + c * 4);
      A[0] = fmaf(a.x, f, A[0]);
      A[1] = fmaf(a.y, f, A[1]);
      A[2] = fmaf(a.z, f, A[2]);
      A[3] = fmaf(a.w, f, A[3]);
    }
    if (S == 1) {
      const float den = L == 0.f ? 1.f : L;
      store4(o + (head0 + g) * D + c * 4, A[0] / den, A[1] / den, A[2] / den, A[3] / den);
    } else {
      store4(ws_acc + ((split0 + s) * G + g) * D + c * 4, A[0], A[1], A[2], A[3]);
      if (c == 0) ws_ml[(split0 + s) * G + g] = make_float2(M, L);
    }
  }
}

// ---- the merge kernel ------------------------------------------------------

// block (h, b) merges the partials of its G heads: output chunk i of 4
// values a group of J lanes (J a power of two, J * items <= kMergeThreads),
// lane j of the group taking splits j, j + J, ... with an online merge, and
// the J lanes' merges joined by shuffles.  Every split's partial is loaded
// without waiting for the length (a split past it wrote none, and its
// garbage is masked by select), so the loads of a pass are in flight at
// once with the length's
template <typename T, int D>
__global__ void __launch_bounds__(kMergeThreads, 1)
paged_decode_merge(const float* __restrict__ ws_acc, const float2* __restrict__ ws_ml,
                   const int* __restrict__ lengths, T* __restrict__ o, int Hk, int G, int page,
                   int P, int S) {
  constexpr int C4 = D / 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int used = used_splits(lengths[b], page, P, S);
  const long long split0 = (static_cast<long long>(b) * Hk + h) * S;  // first split's index
  const long long head0 = static_cast<long long>(b) * Hk * G + static_cast<long long>(h) * G;
  const int items = G * C4;
  int J = 1;
  while (J < 32 && 2 * J * items <= kMergeThreads) J *= 2;
  const int j = threadIdx.x % J;
  for (int base = 0; base < items; base += kMergeThreads / J) {
    const int item = base + static_cast<int>(threadIdx.x) / J;
    const bool on = item < items;
    const int g = on ? item / C4 : 0, c = on ? item - g * C4 : 0;
    float m = kNegInf, l = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int sp = j; sp < S; sp += J) {
      const float2 ml = ws_ml[(split0 + sp) * G + g];
      const float4 x =
          *reinterpret_cast<const float4*>(ws_acc + ((split0 + sp) * G + g) * D + c * 4);
      const bool live = on && sp < used;
      const float mn = live ? fmaxf(m, ml.x) : m;
      const float f0 = expf(m - mn), f1 = live ? expf(ml.x - mn) : 0.f;
      l = fmaf(l, f0, live ? ml.y * f1 : 0.f);
      a = live ? make_float4(fmaf(a.x, f0, x.x * f1), fmaf(a.y, f0, x.y * f1),
                             fmaf(a.z, f0, x.z * f1), fmaf(a.w, f0, x.w * f1))
               : a;
      m = mn;
    }
    for (int off = 1; off < J; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m, off);
      const float lo = __shfl_xor_sync(0xffffffffu, l, off);
      float4 ao;
      ao.x = __shfl_xor_sync(0xffffffffu, a.x, off);
      ao.y = __shfl_xor_sync(0xffffffffu, a.y, off);
      ao.z = __shfl_xor_sync(0xffffffffu, a.z, off);
      ao.w = __shfl_xor_sync(0xffffffffu, a.w, off);
      const float mn = fmaxf(m, mo);
      const float f0 = expf(m - mn), f1 = expf(mo - mn);
      l = fmaf(l, f0, lo * f1);
      a = make_float4(fmaf(a.x, f0, ao.x * f1), fmaf(a.y, f0, ao.y * f1),
                      fmaf(a.z, f0, ao.z * f1), fmaf(a.w, f0, ao.w * f1));
      m = mn;
    }
    if (on && j == 0) {
      const float den = l == 0.f ? 1.f : l;
      store4(o + (head0 + g) * D + c * 4, a.x / den, a.y / den, a.z / den, a.w / den);
    }
  }
}

// ---- launch ----------------------------------------------------------------

template <typename T, int D, int GB>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(paged_decode_split<T, D, GB>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(Shape<T, D, GB>::smem_bytes()));
}

struct Args {
  const void *q, *kp, *vp;
  const int *pt, *lengths;
  void *o, *ws;
  int B, Hk, G, N, page, P, S;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int GB>
cudaError_t launch_typed(const Args& a) {
  cudaError_t err = set_smem<T, D, GB>();
  if (err != cudaSuccess) return err;
  float* ws_acc = static_cast<float*>(a.ws);
  float2* ws_ml =
      a.ws == nullptr
          ? nullptr
          : reinterpret_cast<float2*>(ws_acc + static_cast<size_t>(a.B) * a.Hk * a.S * a.G * D);
  paged_decode_split<T, D, GB>
      <<<dim3(a.Hk, a.B, a.S), kThreads, Shape<T, D, GB>::smem_bytes(), a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.kp), static_cast<const T*>(a.vp),
          a.pt, a.lengths, static_cast<T*>(a.o), ws_acc, ws_ml, a.Hk, a.G, a.N, a.page, a.P, a.S,
          a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.S == 1) return err;
  paged_decode_merge<T, D><<<dim3(a.Hk, a.B), kMergeThreads, 0, a.stream>>>(
      ws_acc, ws_ml, a.lengths, static_cast<T*>(a.o), a.Hk, a.G, a.page, a.P, a.S);
  return cudaGetLastError();
}

template <typename T, int D, int GB>
cudaError_t occupancy_typed(const Args& a, int* blocks) {
  cudaError_t err = set_smem<T, D, GB>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, paged_decode_split<T, D, GB>, kThreads, Shape<T, D, GB>::smem_bytes());
}

// launch (blocks == nullptr) or the occupancy query, at the group bucket of G
template <typename T, int D>
cudaError_t dispatch_group(const Args& a, int* blocks) {
  const int G = a.G;
  if (G <= 1) return blocks ? occupancy_typed<T, D, 1>(a, blocks) : launch_typed<T, D, 1>(a);
  if (G <= 2) return blocks ? occupancy_typed<T, D, 2>(a, blocks) : launch_typed<T, D, 2>(a);
  if (G <= 4) return blocks ? occupancy_typed<T, D, 4>(a, blocks) : launch_typed<T, D, 4>(a);
  if (G <= 8) return blocks ? occupancy_typed<T, D, 8>(a, blocks) : launch_typed<T, D, 8>(a);
  return blocks ? occupancy_typed<T, D, 16>(a, blocks) : launch_typed<T, D, 16>(a);
}

template <typename T>
cudaError_t dispatch_dim(int D, const Args& a, int* blocks) {
  switch (D) {
    case 16: return dispatch_group<T, 16>(a, blocks);
    case 32: return dispatch_group<T, 32>(a, blocks);
    case 64: return dispatch_group<T, 64>(a, blocks);
    case 112: return dispatch_group<T, 112>(a, blocks);
    case 128: return dispatch_group<T, 128>(a, blocks);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(int dtype, int D, const Args& a, int* blocks) {
  if (a.G < 1 || a.G > kMaxG) return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_dim<float>(D, a, blocks);
  if (dtype == 1) return dispatch_dim<__nv_bfloat16>(D, a, blocks);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, H, D), k_pages and v_pages (N, page, Hk, D), o (B, H, D), all
// contiguous with 16-byte aligned bases; page_table (B, P) and lengths (B,)
// int32.  dtype: 0 = float32, 1 = bfloat16 (q, the pools and o).  S splits
// per (b, KV head), at most kMaxSplitPages page slots each (S >=
// ceil(P / kMaxSplitPages)); with S > 1, workspace holds B*H*S*(D+2) f32
// (16-byte aligned).  Returns a CUDA error code (0 on a clean launch); does
// not synchronise.
extern "C" int paged_attention_launch(const void* q, const void* k_pages, const void* v_pages,
                                      const void* page_table, const void* lengths, void* o,
                                      void* workspace, int B, int H, int Hk, int D, int N,
                                      int page, int P, int S, float scale, int dtype,
                                      void* stream) {
  if (B <= 0 || B > 65535 || Hk <= 0 || H % Hk != 0 || N <= 0 || page <= 0 || P < 0 || S < 1 ||
      S > 65535 || static_cast<long long>(P + 1) * page >= (1ll << 31) ||
      static_cast<long long>(S) * kMaxSplitPages < P || (S > 1 && workspace == nullptr))
    return cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, static_cast<const int*>(page_table),
               static_cast<const int*>(lengths), o, workspace, B, Hk, H / Hk, N, page, P, S,
               scale, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, D, a, nullptr);
}

// split blocks of head dim D and G query heads per KV head that one SM holds
// at once, on the current device
extern "C" int paged_attention_blocks_per_sm(int D, int G, int dtype, int* blocks) {
  Args a{};
  a.G = G;
  return dispatch(dtype, D, a, blocks);
}

extern "C" const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
