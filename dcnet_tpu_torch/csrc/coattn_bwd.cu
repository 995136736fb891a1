// K3: the backward of one co-attention direction, for Hopper (sm_90a).
//
// Replaces dcnet_tpu/ops/pallas/coattn.py::_attend_bwd (kernel body
// _attend_bwd_kernel), the VJP that the training step runs twice per scale
// through the pair kernel's backward (_bwd) and once per scale through
// coattention_one's (_one_bwd). For o = W kv, W = softmax_rows(S),
// S = T q kv^T, and the upstream gradient g:
//
//     dW  = g kv^T
//     dS  = W (dW - rowsum(dW * W))
//     dq  = T dS kv
//     dkv = T dS^T q + W^T g
//
// Precision follows the TPU kernel: q, kv and g are read as fp32 and every
// product, exponential and sum is fp32, with the *unrounded* fp32 W (the
// forward rounds W to bf16 before PV for bf16 inputs; the backward does
// not). dq and dkv are rounded once to the input dtype at the end.
//
// Bound per call: 10*B*P^2*C operations (the JAX cost estimate: four
// products of the TPU body plus the softmax) and 5*B*P*C*sizeof(T) bytes
// (q, kv, g read once; dq, dkv written once). Everything is fp32 FMA, so
// the bound is taken at the card's fp32 rate (67 TFLOP/s, not the tensor
// cores): at B = 16, P = 1024, C = 512 that is 1.28 ms, compute-bound.
//
// Design. The TPU kernel holds each row tile's full (R, P) softmax in VMEM
// and accumulates dkv across row tiles of one resident block, which relies
// on the TPU's sequential grid. Hopper blocks run in parallel and in no
// order, and an fp32 (256, 1024) tile alone is 1 MiB, so this is the
// FlashAttention-2 split instead, deterministic (no atomics):
//   1. dq pass (q-major). A block owns kOwn rows of q and g and streams kv
//      in tiles of kStream rows twice. Sweep 1 keeps, per row, the running
//      max m, sum l and a = sum exp(S - m) dW (rescaled as m grows), which
//      gives the logsumexp L = m + log l and D = a / l = rowsum(dW * W) =
//      rowsum(g * o); both go to global scratch. Sweep 2 recomputes S and
//      dW, forms dS = exp(S - L) (dW - D) and accumulates dq = T dS kv in
//      registers.
//   2. dkv pass (kv-major). A block owns kOwn rows of kv and streams q and
//      g in tiles of kStream rows with their L and D; it recomputes W and
//      dS for the tile and accumulates dkv = T dS^T q + W^T g in registers.
// That costs 18 P^2 C operations against the TPU body's 10 (S and dW are
// formed three times), the price of no (R, P) tile. Rows and columns past
// P are masked (zero rows in, W = 0, no store), so ragged P (169 at 416 px)
// works. Operands sit in shared memory as fp32 with a pitch of C + 4
// floats: the dot products read 16-byte vectors along C, where lanes that
// walk different rows land in distinct banks and lanes that share a row get
// a broadcast. Left for later on purpose: the tensor cores (wgmma), cp.async
// or TMA pipelining, and more than one block per SM (~133 KB and ~168 KB of
// shared memory per block at C = 512).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kOwn = 16;                 // rows a block owns
constexpr int kStream = 32;              // streamed rows per tile: one per lane
constexpr int kRowsPerWarp = kOwn / kWarps;
constexpr int kMaxC = 512;
constexpr int kCols = kMaxC / kThreads;  // output columns per thread

__host__ __device__ inline size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

__host__ __device__ inline int pitch(int C) { return C + 4; }

// dq pass: q, g (kOwn rows), kv tile (kStream rows), dS tile, L and D.
__host__ __device__ inline size_t smem_dq(int C) {
  return align128(sizeof(float) * (2 * kOwn + kStream) * pitch(C)) +
         align128(sizeof(float) * kOwn * kStream) +
         align128(sizeof(float) * 2 * kOwn);
}

// dkv pass: kv (kOwn rows), q and g tiles (kStream rows), W^T and T dS^T
// tiles, the tile's L and D.
__host__ __device__ inline size_t smem_dkv(int C) {
  return align128(sizeof(float) * (kOwn + 2 * kStream) * pitch(C)) +
         align128(sizeof(float) * 2 * kOwn * kStream) +
         align128(sizeof(float) * 2 * kStream);
}

__device__ inline float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__device__ inline T from_float(float v);
template <>
__device__ inline float from_float<float>(float v) { return v; }
template <>
__device__ inline bf16 from_float<bf16>(float v) { return __float2bfloat16(v); }

// Copies `rows` rows of C elements, starting at row `row0` of a (P, C)
// row-major matrix, into fp32 shared memory with pitch `ld`; rows past P
// are zero. Global reads are 16-byte vectors (the host checks alignment).
__device__ void load_rows(float* dst, int ld, const float* src, int row0,
                          int rows, int P, int C) {
  const int vecs = C / 4;
  for (int i = threadIdx.x; i < rows * vecs; i += kThreads) {
    const int r = i / vecs;
    const int c = (i - r * vecs) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < P) {
      v = *reinterpret_cast<const float4*>(src + (long long)(row0 + r) * C + c);
    }
    *reinterpret_cast<float4*>(dst + r * ld + c) = v;
  }
}

__device__ void load_rows(float* dst, int ld, const bf16* src, int row0,
                          int rows, int P, int C) {
  const int vecs = C / 8;
  for (int i = threadIdx.x; i < rows * vecs; i += kThreads) {
    const int r = i / vecs;
    const int c = (i - r * vecs) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < P) {
      v = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * C + c);
    }
    const bf16* e = reinterpret_cast<const bf16*>(&v);
    float4 lo = make_float4(__bfloat162float(e[0]), __bfloat162float(e[1]),
                            __bfloat162float(e[2]), __bfloat162float(e[3]));
    float4 hi = make_float4(__bfloat162float(e[4]), __bfloat162float(e[5]),
                            __bfloat162float(e[6]), __bfloat162float(e[7]));
    *reinterpret_cast<float4*>(dst + r * ld + c) = lo;
    *reinterpret_cast<float4*>(dst + r * ld + c + 4) = hi;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// s[i] = <xr[i], y>, d[i] = <zr[i], y> over C, for the kRowsPerWarp rows
// this warp takes; y is this lane's row.
__device__ __forceinline__ void two_dots(const float* const* xr,
                                         const float* const* zr, const float* y,
                                         int C, float* s, float* d) {
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) s[i] = d[i] = 0.f;
  for (int k = 0; k < C; k += 4) {
    const float4 yv = *reinterpret_cast<const float4*>(y + k);
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      s[i] = dot4(*reinterpret_cast<const float4*>(xr[i] + k), yv, s[i]);
      d[i] = dot4(*reinterpret_cast<const float4*>(zr[i] + k), yv, d[i]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ kv,
              const T* __restrict__ g, T* __restrict__ dq,
              float* __restrict__ lse, float* __restrict__ dd, int P, int C,
              long long q_bstride, long long kv_bstride, long long g_bstride,
              float t) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = pitch(C);
  float* q_s = reinterpret_cast<float*>(smem);
  float* g_s = q_s + kOwn * ld;
  float* kv_s = g_s + kOwn * ld;
  float* ds_s = reinterpret_cast<float*>(
      smem + align128(sizeof(float) * (2 * kOwn + kStream) * ld));
  float* l_s = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(ds_s) + align128(sizeof(float) * kOwn * kStream));
  float* d_s = l_s + kOwn;

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kOwn;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* kvb = kv + (long long)b * kv_bstride;

  load_rows(q_s, ld, q + (long long)b * q_bstride, row0, kOwn, P, C);
  load_rows(g_s, ld, g + (long long)b * g_bstride, row0, kOwn, P, C);

  const float* xr[kRowsPerWarp];
  const float* zr[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    xr[i] = q_s + (warp + i * kWarps) * ld;
    zr[i] = g_s + (warp + i * kWarps) * ld;
  }
  float s[kRowsPerWarp], dw[kRowsPerWarp];

  // sweep 1: logsumexp and D per row, online over the kv tiles
  float m[kRowsPerWarp], l[kRowsPerWarp], a[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    a[i] = 0.f;
  }
  for (int n0 = 0; n0 < P; n0 += kStream) {
    __syncthreads();  // the previous tile's readers of kv_s are done
    load_rows(kv_s, ld, kvb, n0, kStream, P, C);
    __syncthreads();
    two_dots(xr, zr, kv_s + lane * ld, C, s, dw);
    const bool valid = n0 + lane < P;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float sv = valid ? s[i] * t : -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(sv));  // column n0 is valid
      const float e = valid ? expf(sv - m_new) : 0.f;
      const float alpha = expf(m[i] - m_new);         // 0 on the first tile
      l[i] = l[i] * alpha + warp_sum(e);
      a[i] = a[i] * alpha + warp_sum(e * dw[i]);
      m[i] = m_new;
    }
  }
  float* lseb = lse + (long long)b * P;
  float* ddb = dd + (long long)b * P;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp + i * kWarps;
    if (lane == 0) {
      l_s[r] = m[i] + logf(l[i]);
      d_s[r] = a[i] / l[i];
      if (row0 + r < P) {
        lseb[row0 + r] = l_s[r];
        ddb[row0 + r] = d_s[r];
      }
    }
  }

  // sweep 2: dq = T dS kv, accumulated in registers (columns c = tid + 256u)
  float acc[kOwn][kCols];
#pragma unroll
  for (int r = 0; r < kOwn; ++r)
#pragma unroll
    for (int u = 0; u < kCols; ++u) acc[r][u] = 0.f;
  for (int n0 = 0; n0 < P; n0 += kStream) {
    __syncthreads();  // l_s/d_s written; the last tile's readers are done
    load_rows(kv_s, ld, kvb, n0, kStream, P, C);
    __syncthreads();
    two_dots(xr, zr, kv_s + lane * ld, C, s, dw);
    const bool valid = n0 + lane < P;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + i * kWarps;
      const float w = valid ? expf(s[i] * t - l_s[r]) : 0.f;
      ds_s[r * kStream + lane] = w * (dw[i] - d_s[r]);
    }
    __syncthreads();
    for (int j = 0; j < kStream; j += 4) {
      float kvv[4][kCols];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int u = 0; u < kCols; ++u) {
          const int c = threadIdx.x + u * kThreads;
          kvv[jj][u] = c < C ? kv_s[(j + jj) * ld + c] : 0.f;
        }
#pragma unroll
      for (int r = 0; r < kOwn; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(ds_s + r * kStream + j);
#pragma unroll
        for (int u = 0; u < kCols; ++u) {
          float v = acc[r][u];
          v = fmaf(p.x, kvv[0][u], v);
          v = fmaf(p.y, kvv[1][u], v);
          v = fmaf(p.z, kvv[2][u], v);
          acc[r][u] = fmaf(p.w, kvv[3][u], v);
        }
      }
    }
  }
  T* dqb = dq + (long long)b * P * C;
#pragma unroll
  for (int r = 0; r < kOwn; ++r) {
    if (row0 + r >= P) continue;
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const int c = threadIdx.x + u * kThreads;
      if (c < C) dqb[(long long)(row0 + r) * C + c] = from_float<T>(t * acc[r][u]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ kv,
               const T* __restrict__ g, T* __restrict__ dkv,
               const float* __restrict__ lse, const float* __restrict__ dd,
               int P, int C, long long q_bstride, long long kv_bstride,
               long long g_bstride, float t) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = pitch(C);
  float* kv_s = reinterpret_cast<float*>(smem);
  float* q_s = kv_s + kOwn * ld;
  float* g_s = q_s + kStream * ld;
  float* w_s = reinterpret_cast<float*>(
      smem + align128(sizeof(float) * (kOwn + 2 * kStream) * ld));
  float* ds_s = w_s + kOwn * kStream;  // T dS, transposed like w_s: [j][r]
  float* l_s = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(w_s) + align128(sizeof(float) * 2 * kOwn * kStream));
  float* d_s = l_s + kStream;

  const int b = blockIdx.y;
  const int col0 = blockIdx.x * kOwn;  // the kv rows this block owns
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qb = q + (long long)b * q_bstride;
  const T* gb = g + (long long)b * g_bstride;
  const float* lseb = lse + (long long)b * P;
  const float* ddb = dd + (long long)b * P;

  load_rows(kv_s, ld, kv + (long long)b * kv_bstride, col0, kOwn, P, C);

  const float* kr[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) kr[i] = kv_s + (warp + i * kWarps) * ld;
  float s[kRowsPerWarp], dw[kRowsPerWarp];

  float acc[kOwn][kCols];
#pragma unroll
  for (int j = 0; j < kOwn; ++j)
#pragma unroll
    for (int u = 0; u < kCols; ++u) acc[j][u] = 0.f;

  for (int r0 = 0; r0 < P; r0 += kStream) {
    __syncthreads();  // the previous tile's readers are done
    load_rows(q_s, ld, qb, r0, kStream, P, C);
    load_rows(g_s, ld, gb, r0, kStream, P, C);
    if (threadIdx.x < kStream) {
      const bool ok = r0 + threadIdx.x < P;
      l_s[threadIdx.x] = ok ? lseb[r0 + threadIdx.x] : 0.f;
      d_s[threadIdx.x] = ok ? ddb[r0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
    // lane = streamed row r; this warp's owned kv rows j: S[r][j], dW[r][j]
    {
      const float* qr = q_s + lane * ld;
      const float* gr = g_s + lane * ld;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) s[i] = dw[i] = 0.f;
      for (int k = 0; k < C; k += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qr + k);
        const float4 gv = *reinterpret_cast<const float4*>(gr + k);
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const float4 kk = *reinterpret_cast<const float4*>(kr[i] + k);
          s[i] = dot4(qv, kk, s[i]);
          dw[i] = dot4(gv, kk, dw[i]);
        }
      }
    }
    const bool valid = r0 + lane < P;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int j = warp + i * kWarps;
      const float w = valid ? expf(s[i] * t - l_s[lane]) : 0.f;
      w_s[j * kStream + lane] = w;
      ds_s[j * kStream + lane] = t * w * (dw[i] - d_s[lane]);
    }
    __syncthreads();
    for (int r = 0; r < kStream; r += 4) {
      float qv[4][kCols], gv[4][kCols];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int u = 0; u < kCols; ++u) {
          const int c = threadIdx.x + u * kThreads;
          qv[rr][u] = c < C ? q_s[(r + rr) * ld + c] : 0.f;
          gv[rr][u] = c < C ? g_s[(r + rr) * ld + c] : 0.f;
        }
#pragma unroll
      for (int j = 0; j < kOwn; ++j) {
        const float4 d4 = *reinterpret_cast<const float4*>(ds_s + j * kStream + r);
        const float4 w4 = *reinterpret_cast<const float4*>(w_s + j * kStream + r);
#pragma unroll
        for (int u = 0; u < kCols; ++u) {
          float v = acc[j][u];
          v = fmaf(d4.x, qv[0][u], v);
          v = fmaf(w4.x, gv[0][u], v);
          v = fmaf(d4.y, qv[1][u], v);
          v = fmaf(w4.y, gv[1][u], v);
          v = fmaf(d4.z, qv[2][u], v);
          v = fmaf(w4.z, gv[2][u], v);
          v = fmaf(d4.w, qv[3][u], v);
          acc[j][u] = fmaf(w4.w, gv[3][u], v);
        }
      }
    }
  }
  T* dkvb = dkv + (long long)b * P * C;
#pragma unroll
  for (int j = 0; j < kOwn; ++j) {
    if (col0 + j >= P) continue;
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const int c = threadIdx.x + u * kThreads;
      if (c < C) dkvb[(long long)(col0 + j) * C + c] = from_float<T>(acc[j][u]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* kv, const void* g, void* dq, void* dkv,
           float* lse, float* dd, int B, int P, int C, long long q_bstride,
           long long kv_bstride, long long g_bstride, float t,
           cudaStream_t stream) {
  const size_t sa = smem_dq(C), sb = smem_dkv(C);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sa);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(bwd_dkv_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sb);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear, so PyTorch's next check does not see it
    return (int)err;
  }
  const dim3 grid((P + kOwn - 1) / kOwn, B);
  bwd_dq_kernel<T><<<grid, kThreads, sa, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv),
      static_cast<const T*>(g), static_cast<T*>(dq), lse, dd, P, C,
      q_bstride, kv_bstride, g_bstride, t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dkv_kernel<T><<<grid, kThreads, sb, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv),
      static_cast<const T*>(g), static_cast<T*>(dkv), lse, dd, P, C,
      q_bstride, kv_bstride, g_bstride, t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, kv, g: (B, P, C) with contiguous rows
// and the given batch strides (elements); dq, dkv: contiguous (B, P, C) in
// the same dtype; lse, dd: fp32 (B, P) scratch. Returns a cudaError_t code,
// 0 on success.
int dcnet_coattn_attend_bwd(const void* q, const void* kv, const void* g,
                            void* dq, void* dkv, void* lse, void* dd, int B,
                            int P, int C, long long q_bstride,
                            long long kv_bstride, long long g_bstride, float t,
                            int dtype, void* stream) {
  if (B <= 0 || P <= 0 || C <= 0 || C % 16 != 0 || C > kMaxC || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* d = static_cast<float*>(dd);
  if (dtype == 0) {
    return launch<float>(q, kv, g, dq, dkv, l, d, B, P, C, q_bstride,
                         kv_bstride, g_bstride, t, s);
  }
  if (dtype == 1) {
    return launch<bf16>(q, kv, g, dq, dkv, l, d, B, P, C, q_bstride,
                        kv_bstride, g_bstride, t, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* dcnet_coattn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
