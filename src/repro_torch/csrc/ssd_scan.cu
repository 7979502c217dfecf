// ssd_scan: the Mamba2 SSD chunked scan (arXiv:2405.21060 S6) for Hopper
// (sm_90a), f32 arithmetic on the CUDA cores.
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
// carries S across chunk steps in VMEM scratch.  Here one block of 256
// threads owns (b, h) and loops over the chunks itself; S (N x dh) stays in
// shared memory for the whole scan.  Shared memory is what the TPU's blocks
// do not fit into: at N = 128, dh = 64, Q = 128 one chunk's B, C, x, S and
// the Q x Q score tile take 256 KB in f32, above the 227 KB a block may
// use.  So the query rows are tiled by kR = 64 and the keys by kK = 32: a
// block holds C for 64 rows, B and x dt for 32 keys, the 64 x 32 score
// tile and S, ~103 KB at full width, and two blocks fit on an SM.  Key
// tiles wholly above the diagonal are skipped.  The last row tile visits
// every key tile of the chunk, so the state update is accumulated there, in
// registers, from the same B and x dt tiles; S is overwritten only after
// every row tile has read it.
//
// What bounds it on this card: operations.  At the serve shape (B 4, L 512,
// H 48, dh 64, N 128, Q 128) the work is ~4 GFLOP (C B^T and the
// intra-chunk product over the causal half, C S and the state update over
// all of it) against ~59 MB of inputs and outputs, so at the f32 peak of
// 67 TFLOP/s the least time is ~0.06 ms, against ~0.02 ms for the bytes.
// The design keeps the FMA units fed from shared memory: each thread reads
// float4s along the contracted axis and keeps a 4 x (dh/16) output tile, a
// 4 x 2 score tile and an (N/16) x (dh/16) state tile in registers.  Later
// work (the kernel redesign): the tensor cores (wgmma; TF32 would change
// the numbers the routes are held to), and computing C B^T once per
// (b, chunk) for all H heads (one B/C group serves them all, and the TPU
// kernel, like this one, recomputes it per head).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 row groups (ty) x 16 column groups (tx)
constexpr int kR = 64;         // query rows per row tile
constexpr int kK = 32;         // keys per key tile
constexpr int kMaxQ = 128;     // longest chunk
constexpr int kLdP = kK + 16;  // row stride of the score tile: rows ty, ty+1 on other banks

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  void* y;
  float* S_out;
  long long sxb, sxl, sxh;  // x strides (elements); dh is contiguous
  long long sdb, sdl, sdh;  // dt strides
  long long sbb, sbl;       // B strides; N is contiguous
  long long scb, scl;       // C strides
  long long sA;             // A stride
  int H, L, Q;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// TN consecutive floats from shared memory, as one vector load where TN
// allows (the caller keeps the address TN-aligned).
template <int TN>
__device__ __forceinline__ void lds(const float* p, float (&v)[TN]) {
  if constexpr (TN == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (TN == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

template <typename T, int N, int DH>
__global__ void __launch_bounds__(kThreads, 2) ssd_chunk_scan(Args a) {
  constexpr int kLdN = N + 4;     // row stride of the C and B tiles; float4-aligned, odd in float4s
  constexpr int TN = DH / 16;     // output columns per thread
  constexpr int TS = N / 16;      // state rows per thread
  constexpr int kRI = kR / 16;    // query rows per thread
  constexpr int kKC = kK / 16;    // keys per thread in the score tile
  static_assert(N % 16 == 0 && DH % 16 == 0 && TN <= 4, "unsupported N or dh");

  extern __shared__ float4 smem4[];
  float* Cs = reinterpret_cast<float*>(smem4);  // [kR][kLdN]   C rows of the row tile
  float* Bs = Cs + kR * kLdN;                    // [kK][kLdN]   B rows of the key tile
  float* Ps = Bs + kK * kLdN;                    // [kR][kLdP]   masked, decayed scores
  float* Xs = Ps + kR * kLdP;                    // [kK][DH]     x * dt of the key tile
  float* Ss = Xs + kK * DH;                      // [N][DH]      the carried state
  float* cs = Ss + N * DH;                       // [kMaxQ]      cumsum(dt * A)
  float* dts = cs + kMaxQ;                       // [kMaxQ]      dt
  float* ws = dts + kMaxQ;                       // [kMaxQ]      exp(cs_last - cs)

  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int Q = a.Q;
  const T* xb = static_cast<const T*>(a.x) + b * a.sxb + h * a.sxh;
  const float* dtb = a.dt + b * a.sdb + h * a.sdh;
  const float* Bb = a.B + b * a.sbb;
  const float* Cb = a.C + b * a.scb;
  T* yb = static_cast<T*>(a.y) + ((long long)b * a.L * a.H + h) * DH;  // y is contiguous
  const float Ah = a.A[h * a.sA];

  for (int i = tid; i < N * DH; i += kThreads) Ss[i] = 0.f;

  for (int c0 = 0; c0 < a.L; c0 += Q) {
    // dt, then cs = cumsum(dt * A) by warp 0 (a scan of 32 at a time), and
    // the state update's weights exp(cs_last - cs)
    for (int j = tid; j < Q; j += kThreads) dts[j] = dtb[(c0 + j) * a.sdl];
    __syncthreads();
    if (tid < 32) {
      float carry = 0.f;
      for (int s0 = 0; s0 < Q; s0 += 32) {
        const int j = s0 + tid;
        float v = j < Q ? dts[j] * Ah : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, o);
          if (tid >= o) v += u;
        }
        v += carry;
        if (j < Q) cs[j] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
      __syncwarp();
      for (int j = tid; j < Q; j += 32) ws[j] = expf(carry - cs[j]);
    }
    __syncthreads();
    const float cs_last = cs[Q - 1];

    float st[TS][TN];  // this chunk's B^T (w o x dt), rows ty + 16 i, columns tx * TN + c
#pragma unroll
    for (int i = 0; i < TS; ++i)
#pragma unroll
      for (int c = 0; c < TN; ++c) st[i][c] = 0.f;

    for (int i0 = 0; i0 < Q; i0 += kR) {
      const bool last = i0 + kR >= Q;
      for (int idx = tid; idx < kR * N; idx += kThreads) {
        const int r = idx / N, n = idx % N;
        Cs[r * kLdN + n] = i0 + r < Q ? Cb[(c0 + i0 + r) * a.scl + n] : 0.f;
      }
      __syncthreads();

      // the state's part: acc = exp(cs_i) * (C_i S)
      float acc[kRI][TN];
#pragma unroll
      for (int i = 0; i < kRI; ++i)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[i][c] = 0.f;
      for (int n = 0; n < N; n += 4) {
        float cr[kRI][4], sv[4][TN];
#pragma unroll
        for (int i = 0; i < kRI; ++i) lds<4>(Cs + (ty + 16 * i) * kLdN + n, cr[i]);
#pragma unroll
        for (int u = 0; u < 4; ++u) lds<TN>(Ss + (n + u) * DH + tx * TN, sv[u]);
#pragma unroll
        for (int i = 0; i < kRI; ++i)
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int c = 0; c < TN; ++c) acc[i][c] = fmaf(cr[i][u], sv[u][c], acc[i][c]);
      }
#pragma unroll
      for (int i = 0; i < kRI; ++i) {
        const int gi = i0 + ty + 16 * i;
        const float e = gi < Q ? expf(cs[gi]) : 0.f;
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[i][c] *= e;
      }

      // the chunk's own part, one key tile at a time up to the diagonal
      const int j_end = min(i0 + kR, Q);
      for (int j0 = 0; j0 < j_end; j0 += kK) {
        __syncthreads();  // the previous tile's Bs, Xs and Ps are no longer read
        for (int idx = tid; idx < kK * N; idx += kThreads) {
          const int k = idx / N, n = idx % N;
          Bs[k * kLdN + n] = j0 + k < Q ? Bb[(c0 + j0 + k) * a.sbl + n] : 0.f;
        }
        for (int idx = tid; idx < kK * DH; idx += kThreads) {
          const int k = idx / DH, d = idx % DH;
          const int j = j0 + k;
          Xs[k * DH + d] = j < Q ? to_f32(xb[(c0 + j) * a.sxl + d]) * dts[j] : 0.f;
        }
        __syncthreads();

        // scores: (C B^T) for rows ty + 16 i and keys tx + 16 c
        float sc[kRI][kKC];
#pragma unroll
        for (int i = 0; i < kRI; ++i)
#pragma unroll
          for (int c = 0; c < kKC; ++c) sc[i][c] = 0.f;
        for (int n = 0; n < N; n += 4) {
          float cr[kRI][4], br[kKC][4];
#pragma unroll
          for (int i = 0; i < kRI; ++i) lds<4>(Cs + (ty + 16 * i) * kLdN + n, cr[i]);
#pragma unroll
          for (int c = 0; c < kKC; ++c) lds<4>(Bs + (tx + 16 * c) * kLdN + n, br[c]);
#pragma unroll
          for (int i = 0; i < kRI; ++i)
#pragma unroll
            for (int c = 0; c < kKC; ++c)
#pragma unroll
              for (int u = 0; u < 4; ++u) sc[i][c] = fmaf(cr[i][u], br[c][u], sc[i][c]);
        }
#pragma unroll
        for (int i = 0; i < kRI; ++i) {
          const int gi = i0 + ty + 16 * i;
#pragma unroll
          for (int c = 0; c < kKC; ++c) {
            const int gj = j0 + tx + 16 * c;
            // masked before the exp: only j <= i < Q reaches it
            const float p = (gi < Q && gj <= gi) ? sc[i][c] * expf(cs[gi] - cs[gj]) : 0.f;
            Ps[(ty + 16 * i) * kLdP + tx + 16 * c] = p;
          }
        }

        // the state update's terms, from the same tiles, in the last row tile
        if (last) {
          for (int k = 0; k < kK; ++k) {
            const float w = j0 + k < Q ? ws[j0 + k] : 0.f;
            float xv[TN];
            lds<TN>(Xs + k * DH + tx * TN, xv);
#pragma unroll
            for (int i = 0; i < TS; ++i) {
              const float bw = Bs[k * kLdN + ty + 16 * i] * w;
#pragma unroll
              for (int c = 0; c < TN; ++c) st[i][c] = fmaf(bw, xv[c], st[i][c]);
            }
          }
        }
        __syncthreads();

        // acc += P (x dt)
        for (int k = 0; k < kK; k += 4) {
          float pr[kRI][4], xv[4][TN];
#pragma unroll
          for (int i = 0; i < kRI; ++i) lds<4>(Ps + (ty + 16 * i) * kLdP + k, pr[i]);
#pragma unroll
          for (int u = 0; u < 4; ++u) lds<TN>(Xs + (k + u) * DH + tx * TN, xv[u]);
#pragma unroll
          for (int i = 0; i < kRI; ++i)
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int c = 0; c < TN; ++c) acc[i][c] = fmaf(pr[i][u], xv[u][c], acc[i][c]);
        }
      }

#pragma unroll
      for (int i = 0; i < kRI; ++i) {
        const int gi = i0 + ty + 16 * i;
        if (gi < Q) {
          T* yr = yb + (long long)(c0 + gi) * a.H * DH + tx * TN;
#pragma unroll
          for (int c = 0; c < TN; ++c) from_f32(yr + c, acc[i][c]);
        }
      }
      __syncthreads();  // Cs is reloaded by the next row tile; Ss is read no more this chunk
    }

    // S <- exp(cs_last) S + B^T (w o x dt); each thread its own entries
    const float decay = expf(cs_last);
#pragma unroll
    for (int i = 0; i < TS; ++i)
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        float* s = Ss + (ty + 16 * i) * DH + tx * TN + c;
        *s = fmaf(decay, *s, st[i][c]);
      }
    __syncthreads();
  }

  float* So = a.S_out + ((long long)b * a.H + h) * N * DH;
  for (int i = tid; i < N * DH; i += kThreads) So[i] = Ss[i];
}

size_t smem_bytes(int N, int DH) {
  return sizeof(float) * (size_t)(kR * (N + 4) + kK * (N + 4) + kR * kLdP + kK * DH + N * DH +
                                  3 * kMaxQ);
}

template <typename T, int N, int DH>
cudaError_t launch_typed(const Args& a, int blocks, cudaStream_t stream) {
  const size_t smem = smem_bytes(N, DH);
  static bool configured = false;  // the attribute is set once per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_scan<T, N, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  ssd_chunk_scan<T, N, DH><<<blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t launch_dh(int DH, const Args& a, int blocks, cudaStream_t stream) {
  switch (DH) {
    case 16: return launch_typed<T, N, 16>(a, blocks, stream);
    case 32: return launch_typed<T, N, 32>(a, blocks, stream);
    case 64: return launch_typed<T, N, 64>(a, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_n(int N, int DH, const Args& a, int blocks, cudaStream_t stream) {
  switch (N) {
    case 16: return launch_dh<T, 16>(DH, a, blocks, stream);
    case 64: return launch_dh<T, 64>(DH, a, blocks, stream);
    case 128: return launch_dh<T, 128>(DH, a, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (Bt, L, H, dh) with the strides given (elements; dh contiguous), dt
// (Bt, L, H) and A (H,) f32 with the strides given, B and C (Bt, L, N) f32
// with the strides given (N contiguous); y (Bt, L, H, dh) contiguous in x's
// dtype, S_out (Bt, H, N, dh) contiguous f32.  dtype: 0 = float32,
// 1 = bfloat16 (x and y).  N in {16, 64, 128}, dh in {16, 32, 64},
// 1 <= chunk <= 128 dividing L.  Returns a CUDA error code (0 on a clean
// launch); does not synchronise.
extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* A, const void* B, const void* C, void* y,
    void* S_out, long long sxb, long long sxl, long long sxh, long long sdb, long long sdl,
    long long sdh, long long sbb, long long sbl, long long scb, long long scl, long long sA,
    int Bt, int L, int H, int dh, int N, int chunk, int dtype, void* stream) {
  if (Bt <= 0 || L <= 0 || H <= 0 || chunk <= 0 || chunk > kMaxQ || L % chunk != 0)
    return cudaErrorInvalidValue;
  Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A),
         static_cast<const float*>(B), static_cast<const float*>(C), y,
         static_cast<float*>(S_out), sxb, sxl, sxh, sdb, sdl, sdh, sbb, sbl, scb, scl, sA,
         H, L, chunk};
  auto st = static_cast<cudaStream_t>(stream);
  const int blocks = Bt * H;
  if (dtype == 0) return launch_n<float>(N, dh, a, blocks, st);
  if (dtype == 1) return launch_n<__nv_bfloat16>(N, dh, a, blocks, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
