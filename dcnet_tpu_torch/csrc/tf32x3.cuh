// fp32 products on Hopper's tensor cores by 3xTF32, shared by the fp32
// co-attention block (attend_tf32.cuh: K1, K2, K4's fp32 rings) and the
// backward K3 (coattn_bwd.cu).
//
// One TF32 pass keeps 10 mantissa bits of each operand: on the co-attention's
// l2-normalised rows at T = 10 that misses the fp32 limits (relative l2 1e-4)
// by about 3x. 3xTF32 writes each fp32 operand x as big + small, with
// big = x rounded to TF32 and small = x - big, and adds
//     a_small b_big + a_big b_small + a_big b_big
// on mma.sync m16n8k8 (fp32 accumulate), which keeps fp32 accuracy (the
// tensor cores read small to TF32 by dropping its 13 low bits, at most
// 2^-21 of x; the dropped a_small b_small term is about 2^-22 of the
// product) at a third of the TF32 rate (495 / 3 = 165 TFLOP/s on the H100).
// The split is two integer operations and one subtraction (big: add half a
// TF32 step to the bits and clear the 13 low ones, round to nearest), as
// CUTLASS's fast fp32 product does, in place of two cvt.rna.tf32.f32. An
// operand that is exact in TF32 (a bf16 value)
// has no small part, and its passes are skipped. The split happens in
// registers as each fragment is loaded; shared memory holds each operand
// once, in its input dtype.
//
// Fragments of m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row-major):  a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B (8 x 8, "col"):       b0 (k=t, n=g), b1 (k=t+4, n=g)
//   C/D (16 x 8):           d0 (g, 2t), d1 (g, 2t+1), d2 (g+8, 2t), d3 (g+8, 2t+1)
// The accumulator layout is not the A layout. A product whose A operand is an
// accumulator (the softmax weights in PV, dS and W in K3) does not shuffle:
// the sum index k of one 8-step is permuted instead, logical column t
// standing for k = 2t and t+4 for k = 2t+1, so A = (d0, d2, d1, d3) of the
// accumulator tile, and the B fragment reads rows 2t and 2t+1 (load_b_n).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dcnet {
namespace tf32 {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

// x rounded to TF32 (to nearest, ties away from zero), as fp32 bits.
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

struct FragA {
  uint32_t big[4], small[4];
};

struct FragB {
  uint32_t big[2], small[2];
};

// big and small parts of x; an operand exact in TF32 (kWhole: a bf16
// value) is its own big part and has no small part.
template <bool kWhole>
__device__ __forceinline__ void put(uint32_t& big, uint32_t& small, float x) {
  if constexpr (kWhole) {
    big = __float_as_uint(x);
    small = 0u;
  } else {
    big = round_tf32(x);
    small = __float_as_uint(x - __uint_as_float(big));  // read as TF32 by the mma
  }
}

// d += a b, one TF32 tensor-core pass.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b by 3xTF32; the pass of an operand without a small part (kSmallA
// or kSmallB false) is skipped. The small terms go in first.
template <bool kSmallA, bool kSmallB>
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  if constexpr (kSmallA) mma(d, a.small, b.big);
  if constexpr (kSmallB) mma(d, a.big, b.small);
  mma(d, a.big, b.big);
}

// As mma3, with the small terms into their own accumulator e, which the
// caller adds to d at the end: two dependency chains where one long chain
// would wait on each pass (the score products' few accumulators).
template <bool kSmallA, bool kSmallB>
__device__ __forceinline__ void mma3(float (&d)[4], float (&e)[4], const FragA& a,
                                     const FragB& b) {
  if constexpr (kSmallA) mma(e, a.small, b.big);
  if constexpr (kSmallB) mma(e, a.big, b.small);
  mma(d, a.big, b.big);
}

__device__ __forceinline__ float value(const float* p) { return *p; }
__device__ __forceinline__ float value(const bf16* p) { return __bfloat162float(*p); }

// bf16 values are exact in TF32: no small part
template <typename T>
constexpr bool kExact = sizeof(T) == 2;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 matrices of 16-bit pairs from shared memory: lane l gives the
// address of row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned) and
// receives in r[j] the 32-bit word (l / 4, l % 4) of matrix j. On fp32 rows
// a matrix is 8 rows x 4 floats, and r[j] the float at row g, column t.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// A from a row-major matrix m (rows of pitch ld): m[g][t], m[g+8][t],
// m[g][t+4], m[g+8][t+4]. fp32 rows (16-byte aligned, ld % 4 == 0) take one
// ldmatrix.
template <typename T>
__device__ __forceinline__ void load_a(FragA& f, const T* m, int ld, int lane) {
  if constexpr (sizeof(T) == 4) {
    uint32_t r[4];
    ldsm_x4(r, m + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ld + 4 * (lane >> 4));
#pragma unroll
    for (int j = 0; j < 4; ++j) put<false>(f.big[j], f.small[j], __uint_as_float(r[j]));
  } else {
    const T* p = m + (lane >> 2) * ld + (lane & 3);
    put<kExact<T>>(f.big[0], f.small[0], value(p));
    put<kExact<T>>(f.big[1], f.small[1], value(p + 8 * ld));
    put<kExact<T>>(f.big[2], f.small[2], value(p + 4));
    put<kExact<T>>(f.big[3], f.small[3], value(p + 8 * ld + 4));
  }
}

// B of two adjacent 8-column tiles, B[k][n] = m[n][k] (m row-major, its
// rows are the columns n): f0 from rows 0-7 (m[g][t], m[g][t+4]), f1 from
// rows 8-15. fp32 rows take one ldmatrix.
template <typename T>
__device__ __forceinline__ void load_b_k2(FragB& f0, FragB& f1, const T* m, int ld,
                                          int lane) {
  if constexpr (sizeof(T) == 4) {
    uint32_t r[4];
    ldsm_x4(r, m + ((lane & 7) + 8 * (lane >> 4)) * ld + 4 * ((lane >> 3) & 1));
    put<false>(f0.big[0], f0.small[0], __uint_as_float(r[0]));
    put<false>(f0.big[1], f0.small[1], __uint_as_float(r[1]));
    put<false>(f1.big[0], f1.small[0], __uint_as_float(r[2]));
    put<false>(f1.big[1], f1.small[1], __uint_as_float(r[3]));
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      FragB& f = h ? f1 : f0;
      const T* p = m + (8 * h + (lane >> 2)) * ld + (lane & 3);
      put<kExact<T>>(f.big[0], f.small[0], value(p));
      put<kExact<T>>(f.big[1], f.small[1], value(p + 4));
    }
  }
}

// B[k][n] = m[k][n] with the permuted sum index of A operands taken from
// accumulators: m[2t][g], m[2t+1][g].
template <typename T>
__device__ __forceinline__ void load_b_n(FragB& f, const T* m, int ld, int lane) {
  const T* p = m + 2 * (lane & 3) * ld + (lane >> 2);
  put<kExact<T>>(f.big[0], f.small[0], value(p));
  put<kExact<T>>(f.big[1], f.small[1], value(p + ld));
}

// A from an accumulator tile d (16 rows x 8 sum indices), permuted as
// load_b_n expects; always split (an fp32 operand).
__device__ __forceinline__ void acc_to_a(FragA& f, const float (&d)[4]) {
  put<false>(f.big[0], f.small[0], d[0]);
  put<false>(f.big[1], f.small[1], d[2]);
  put<false>(f.big[2], f.small[2], d[1]);
  put<false>(f.big[3], f.small[3], d[3]);
}

// --- asynchronous copies -----------------------------------------------------

// 16 bytes from global src to shared dst, or 16 zero bytes when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Starts the copy of `rows` rows of C elements from row `row0` of a (P, C)
// row-major matrix into shared memory with pitch ld (16-byte aligned rows);
// rows past P are zero. `threads` threads take part.
template <typename T>
__device__ __forceinline__ void load_rows_async(T* dst, int ld, const T* src,
                                                int row0, int rows, int P, int C,
                                                int threads) {
  constexpr int V = 16 / sizeof(T);
  const int vecs = C / V;
  for (int i = threadIdx.x; i < rows * vecs; i += threads) {
    const int r = i / vecs;
    const int c = (i - r * vecs) * V;
    const bool ok = row0 + r < P;
    cp_async16(dst + r * ld + c, src + (long long)(ok ? row0 + r : 0) * C + c, ok);
  }
}

// Quad reductions: the four threads of a quad hold one accumulator row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The n8 channel tiles a warp of channel group cg (of `groups`) owns out of
// C / 8: the first one and how many (at most C / (8 groups) rounded up).
struct Channels {
  int first, count;
};

__device__ __forceinline__ Channels channel_group(int cg, int groups, int C) {
  const int nt = C / 8, base = nt / groups, rem = nt % groups;
  return {cg * base + min(cg, rem), base + (cg < rem ? 1 : 0)};
}

}  // namespace tf32
}  // namespace dcnet
