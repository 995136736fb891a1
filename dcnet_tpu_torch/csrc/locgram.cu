// K5: the fused location Gram for Hopper (sm_90a).
//
// Replaces dcnet_tpu/ops/pallas/locgram.py::fused_loc_gram (kernel body
// _kernel), the location branch of the reference model:
//
//     out[b] = ReLU((ce[b] ce[b]^T * obj[b][None, :]) W + bias)
//
// ce (B, P, E) in fp32 or bf16 with E <= 16, obj (B, P) fp32, W (P, C) fp32
// (BatchNorm already folded in), bias (C,) fp32; out (B, P, C) in ce's
// dtype. As in the TPU kernel the Gram is formed in fp32 and the product
// sums in fp32. The JAX package computes the same function through the
// exact rank-E factorisation ce (ce^T (obj * W)) and never calls the TPU
// kernel; this port of it runs only in chip_smoke.py's kernel phase.
//
// Bound per launch: the function needs no more than 4*B*P*E*C operations
// (the rank-E factorisation, two products of inner size P and E), against
// 4*(B*P*(E+1) + P*C + C) bytes read (ce at its itemsize) and B*P*C*itemsize
// written. At B = 8, P = 1344, C = 512, E = 8 in fp32 that is 0.18 GFLOP
// (0.0026 ms at the 67 TFLOP/s fp32 peak) against 2.8 MB read and 22 MB
// written, 0.0075 ms at 3.35 TB/s: bound by bytes. This kernel computes the
// TPU kernel's algorithm, the Gram and then its product with W: 2*B*P^2*(E +
// C) operations, 15.0 GFLOP at that shape (0.224 ms at the fp32 peak), about
// P/(2E) = 84x the work the function needs.
//
// Design. The TPU kernel holds the whole (P, C) W in VMEM (2.75 MB at
// P = 1344), far above a block's 227 KB of shared memory. Here a block owns
// 64 rows by 128 output columns (grid (C/128, ceil(P/64), B): 672 blocks at
// B = 8) and walks P in k-tiles of 32: for each it builds the 64 x 32 Gram
// tile in shared memory from its own ce rows, the tile's ce rows and obj (E
// FMAs an element, about 6% of the block's work since each column block
// rebuilds it), while the 32 x 128 tile of W arrives by cp.async into the
// other of two buffers. 256 threads accumulate 8 x 4 outputs each in
// registers, an fp32 FMA loop fed by two broadcast and one conflict-free
// 16-byte shared-memory load per 32 FMAs. The epilogue adds the bias,
// applies ReLU and stores in ce's dtype. Ragged P is masked: Gram columns
// past P are zero (obj is read as 0 there, W rows as 0) and rows past P are
// not stored; columns past C are neither read nor stored. Tensor cores
// (3xTF32) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kRows = 64;      // output rows of a block
constexpr int kCols = 128;     // output columns of a block
constexpr int kTileK = 32;     // Gram columns (= W rows) per k-tile
constexpr int kMaxE = 16;

__device__ inline float to_float(float v) { return v; }
__device__ inline float to_float(bf16 v) { return __bfloat162float(v); }

__device__ inline void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}

__device__ inline void store4(bf16* dst, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
}

// 16 bytes from src into shared dst, or zeros where `valid` is false.
__device__ inline void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(n) : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// W rows k0..k0+31, columns c0..c0+127 into dst[32][128] (zeros past P, C).
__device__ inline void load_w_tile(float* dst, const float* w, int k0, int c0,
                                   int P, int C) {
  for (int i = threadIdx.x; i < kTileK * kCols / 4; i += kThreads) {
    const int k = i / (kCols / 4), c = (i % (kCols / 4)) * 4;
    const bool valid = k0 + k < P && c0 + c < C;
    const float* src = valid ? w + (long long)(k0 + k) * C + c0 + c : w;
    cp_async16(dst + k * kCols + c, src, valid);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
loc_gram_kernel(const T* __restrict__ ce, const float* __restrict__ obj,
                const float* __restrict__ w, const float* __restrict__ bias,
                T* __restrict__ out, int P, int E, int C) {
  __shared__ float ce_rows[kRows][kMaxE + 1];
  __shared__ float ce_cols[kTileK][kMaxE + 1];
  __shared__ float obj_s[kTileK];
  __shared__ __align__(16) float gram_t[kTileK][kRows];  // [k][row]
  __shared__ __align__(16) float w_s[2][kTileK * kCols];

  const int c0 = blockIdx.x * kCols;
  const int r0 = blockIdx.y * kRows;
  const long long b = blockIdx.z;
  const T* ce_b = ce + b * P * E;
  const float* obj_b = obj + b * P;
  const int tx = threadIdx.x % 32;  // columns 4 tx .. 4 tx + 3
  const int ty = threadIdx.x / 32;  // rows 8 ty .. 8 ty + 7

  for (int i = threadIdx.x; i < kRows * E; i += kThreads) {
    const int r = i / E, e = i % E;
    ce_rows[r][e] = r0 + r < P ? to_float(ce_b[(long long)(r0 + r) * E + e]) : 0.f;
  }
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  const int tiles = (P + kTileK - 1) / kTileK;
  load_w_tile(w_s[0], w, 0, c0, P, C);
  cp_async_commit();
  for (int kt = 0; kt < tiles; ++kt) {
    const int k0 = kt * kTileK;
    if (kt + 1 < tiles) {  // the other buffer's readers finished last tile
      load_w_tile(w_s[(kt + 1) & 1], w, k0 + kTileK, c0, P, C);
    }
    cp_async_commit();  // an empty group on the last tile keeps the count
    for (int i = threadIdx.x; i < kTileK * E; i += kThreads) {
      const int k = i / E, e = i % E;
      ce_cols[k][e] = k0 + k < P ? to_float(ce_b[(long long)(k0 + k) * E + e]) : 0.f;
    }
    if (threadIdx.x < kTileK) {
      obj_s[threadIdx.x] = k0 + threadIdx.x < P ? obj_b[k0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kTileK * kRows; i += kThreads) {
      const int k = i / kRows, r = i % kRows;
      float g = 0.f;
      for (int e = 0; e < E; ++e) g = fmaf(ce_rows[r][e], ce_cols[k][e], g);
      gram_t[k][r] = g * obj_s[k];
    }
    cp_async_wait<1>();  // this tile's W has landed
    __syncthreads();
    const float* wt = w_s[kt & 1];
#pragma unroll 8
    for (int k = 0; k < kTileK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&gram_t[k][8 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&gram_t[k][8 * ty + 4]);
      const float4 bv = *reinterpret_cast<const float4*>(wt + k * kCols + 4 * tx);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
    }
    __syncthreads();  // gram_t, ce_cols and this W buffer are free again
  }
  cp_async_wait<0>();

  const int c = c0 + 4 * tx;
  if (c >= C) return;
  const float4 bv = *reinterpret_cast<const float4*>(bias + c);
  T* ob = out + b * P * C;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + 8 * ty + i;
    if (r >= P) break;
    const float4 v = make_float4(fmaxf(acc[i][0] + bv.x, 0.f), fmaxf(acc[i][1] + bv.y, 0.f),
                                 fmaxf(acc[i][2] + bv.z, 0.f), fmaxf(acc[i][3] + bv.w, 0.f));
    store4(ob + (long long)r * C + c, v);
  }
}

template <typename T>
int launch(const void* ce, const float* obj, const float* w, const float* bias,
           void* out, int B, int P, int E, int C, cudaStream_t stream) {
  const dim3 grid((C + kCols - 1) / kCols, (P + kRows - 1) / kRows, B);
  loc_gram_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(ce), obj, w, bias, static_cast<T*>(out), P, E, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ce (B, P, E) contiguous, dtype 0 = float32, 1 = bfloat16; obj (B, P), w
// (P, C) and bias (C,) contiguous float32; out (B, P, C) contiguous in ce's
// dtype. Needs E <= 16 and C % 4 == 0 with 16-byte aligned w, bias and out.
// Returns a cudaError_t code, 0 on success.
int dcnet_loc_gram(const void* ce, const void* obj, const void* w,
                   const void* bias, void* out, int B, int P, int E, int C,
                   int dtype, void* stream) {
  if (B <= 0 || P <= 0 || E <= 0 || E > kMaxE || C <= 0 || C % 4 != 0 ||
      B > 65535 || (P + kRows - 1) / kRows > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* o = static_cast<const float*>(obj);
  const float* wt = static_cast<const float*>(w);
  const float* bs = static_cast<const float*>(bias);
  if (dtype == 0) return launch<float>(ce, o, wt, bs, out, B, P, E, C, s);
  if (dtype == 1) return launch<bf16>(ce, o, wt, bs, out, B, P, E, C, s);
  return (int)cudaErrorInvalidValue;
}

const char* dcnet_loc_gram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
