// Tensor-core building blocks shared by the port's CUDA kernels (sm_90a):
// 3xTF32 products on mma.sync, bf16 products, and cp.async tile copies.
//
// 3xTF32 keeps f32 accuracy on the TF32 tensor cores.  Each f32 operand is
// split into big = tf32(a), a with its low 13 mantissa bits cleared, and
// small = a - big (exact in f32; the tensor core reads the top 19 bits of a
// .tf32 operand, so it is truncated to TF32 there), and a product is formed
// as
//     small_a * big_b + big_a * small_b + big_a * big_b
// with f32 accumulation, small terms first.  The dropped small * small term
// and the truncation of `small` are ~2^-20 of the product, near f32's own
// rounding (2^-24); one TF32 pass keeps ~2^-10.  Truncating takes one logic
// op, where cvt.rna.tf32.f32 costs more on the products' critical path.
// tests/test_torch_tf32.py emulates the split on the CPU.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k8" / "k16"),
// with g = lane / 4 and t = lane % 4:
//   m16n8k8 .tf32  A (row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//                  B (col): b0 (k t, n g), b1 (k t + 4, n g)
//   m16n8k16 .bf16 A (row): a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t+8..), a3 (g + 8, 2t+8..)
//                  B (col): b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   both, C and D:          c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// The low half of a packed bf16 pair holds the smaller index.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace tc {

// x = big + small, both as .tf32 operands (see above)
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

template <int K>
__device__ __forceinline__ void split(const float (&x)[K], uint32_t (&big)[K], uint32_t (&small)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) split(x[i], big[i], small[i]);
}

// d += a b on m16n8k8, TF32 inputs, f32 accumulation.  Not volatile: the
// compiler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b on m16n8k16, bf16 inputs (products exact in f32), f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[n] += a b[n] in 3xTF32 for NT n-tiles that share one A fragment; each
// pass runs over all n-tiles, so no product waits on the one before it.
// With exact_b (B holds bf16 values, exact in TF32) the b-small pass is
// skipped: its terms are zero.
template <int NT, bool exact_b = false>
__device__ __forceinline__ void mma_3xtf32(float (&d)[NT][4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[NT][2],
                                           const uint32_t (&b_small)[NT][2]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) mma_tf32(d[n], a_small, b_big[n]);
  if constexpr (!exact_b) {
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(d[n], a_big, b_small[n]);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) mma_tf32(d[n], a_big, b_big[n]);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// 16 bytes global -> shared, asynchronously; with pred false the 16 bytes
// are zero-filled and nothing is read (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Rows [0, rows) of a tile of `cols` elements of T each (cols * sizeof(T)
// a multiple of 16; rows 16-byte aligned in global and shared memory) from
// src (row stride ld elements) into dst (row stride lds elements), by the
// whole block; rows at or past `valid` become zeros.
template <typename T>
__device__ __forceinline__ void load_rows_async(T* dst, int lds, const T* src, long long ld,
                                                int cols, int rows, int valid) {
  constexpr int kPer = 16 / sizeof(T);
  const int per_row = cols / kPer;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i % per_row) * kPer;
    const bool ok = r < valid;
    cp_async16(dst + r * lds + c, ok ? src + r * ld + c : src, ok);
  }
}

}  // namespace tc
