// K6: the int8 convolution for Hopper (sm_90a), an NHWC implicit GEMM on
// the int8 tensor cores with a fused epilogue. This header holds what K6's
// routes share (the epilogue `finish`, the quantize step), the quantize
// pass and the gather route with their host entries, templated on the
// input type; conv_s8.cu (int8 x), conv_s8_bf16.cu and conv_s8_fp32.cu each
// export them for one type as a library of its own, with the halo route
// (thin reductions, conv_s8_halo.cuh) of that type; the main route, wgmma
// s8 on TMA tiles, is conv_s8_tma.cuh (library conv_s8_tma.cu);
// kernels/conv_s8.py::conv_plan picks the route by shape and alignment.
//
// No TPU kernel stands behind it: the JAX package runs its int8 convolutions
// through XLA, lax.conv_general_dilated(int8, int8,
// preferred_element_type=int32) -- the backbone's in
// dcnet_tpu/ops/quant.py::int8_conv_fn (:224-236), the trunk's in
// dcnet_tpu/models/heads.py::QuantConv2D (:93-96, :121-132) -- and PyTorch
// has no int8 convolution on CUDA.
//
//     acc[n, ho, wo, co] = sum_{r, c, ci} x[n, ho*s - p + r, wo*s - p + c, ci]
//                                         * w[co, r, c, ci]        (int32)
//
// x (N, H, W, Ci) int8, w (Co, k, k, Ci) int8, any N, H, W, Ci, Co >= 1,
// k in {1, 3} (any k the grid fits), stride s >= 1, pad p >= 0; taps outside
// the image read zero. The sum is exact: |acc| <= 127^2 k^2 Ci < 2^31.
// x may also be fp32 or bf16, quantized with the static scale of the JAX
// package's quantize step: clamp(rint(x * inv), -127, 127) (the backbone,
// `inv` a float) or clamp(rint(x / s), -127, 127) (the trunk, `s` an fp32
// on the device; an IEEE division).
//
// The epilogue, per output element, in this order (each step optional):
//     acc += addend[arow, co]                int32; arow = (row / (R*HW))*HW
//                                            + row % HW (the split corr_conv:
//                                            the shared half's sum, once for
//                                            the R parts of a row)
//     y = fmaf(float(acc), scale[co], bias[co])        one rounding
//     y = fmaf(y, scale2[co], bias2[co])               one rounding
//     y = relu(y) | leaky(y) = y >= 0 ? y : 0.1f * y
//     out = y (fp32) | bf16(y) (round to nearest even)
//         | clamp(rint(y * inv_next), -127, 127) (int8, the int8 chain)
// or, with no scale, the raw int32 sums. The multiply-add is a fused one
// (__fmaf_rn) on purpose: XLA's CPU backend contracts the JAX package's
// `y.astype(f32) * scale + bias` and the trunk's `acc * s -> BatchNorm`
// into FMAs, and `kernels/conv_s8.py::fma32` emulates exactly this rounding
// on the CPU. Split into a multiply and an add it would round twice and
// move int8 codes downstream.
//
// The quantize pass (`quant_pass_kernel`): x (rows, Ci) fp32 / bf16 / int8
// into an int8 copy (rows, Cp), Cp = Ci rounded up to 16, the pad zero: the
// TMA route's input where x is float (quantized once, not once for each
// column block of the convolution: quantizing bf16 boxes inside the wgmma
// kernel instead measured 1.09-2.4x slower, PERF.md section 6) or its
// channels are not a multiple of 16 (w's too). Bound by bytes: rows (Ci size(x) + Cp) at 3.35 TB/s. 16 channels a
// thread, 16-byte stores; loads of 16 values where the row's chunk is
// whole and 16-byte aligned, single values otherwise.
//
// The gather route (the first mma.sync kernel, `conv_s8_kernel`): the
// shapes no path runs and neither other route takes -- a thin reduction
// (Ci < 64 or k^2 Ci < 256) the halo route cannot map (x not 16-byte
// aligned, rows of x not 16-byte multiples), an int8 x or a w whose data is
// not 16-byte aligned and that needs no padded copy, strides whose phase
// views overlap, k > 8.
// A block of 128 threads computes a 128 x 64 tile of the (N Ho Wo) x Co
// output over k-tiles of 64 bytes of the k^2 Ci reduction, three stages
// deep in shared memory (46,080 B, static). Row r of the A tile is the
// im2col row of output pixel m0 + r, gathered by thread r: 16-byte cp.async
// where Ci % 16 == 0 (a chunk never crosses a tap), 4-byte cp.async where
// Ci % 4 == 0, and single bytes through registers otherwise; a float x is
// loaded at the same widths into registers and quantized there as each
// tile is staged. Taps in the padding and columns past k^2 Ci are
// zero-filled. The weight tile is 64 rows of w, contiguous in k^2 Ci, with
// the same vector width. Four warps, 2 x 2, each 64 x 32 outputs: 16
// mma.sync.m16n8k32 s8 x s8 -> s32 a 32-byte step, fragments read as 32-bit
// words from rows 80 bytes apart (no bank conflicts). The epilogue writes
// the block's finished 128 x 64 tile into the (then idle) pipeline's shared
// memory and copies it out row by row in 16-byte vectors.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;      // output pixels a block
constexpr int kBN = 64;       // output channels a block
constexpr int kBK = 64;       // bytes of the reduction a k-tile
constexpr int kStages = 3;
constexpr int kThreads = 128;
constexpr int kPitch = kBK + 16;  // bytes between rows in shared memory

enum Mode { kInt32 = 0, kFloat = 1, kBf16 = 2, kInt8 = 3 };
enum Act { kNone = 0, kRelu = 1, kLeaky = 2 };

enum Quant { kQuantNone = 0, kQuantMul = 1, kQuantDiv = 2 };

struct Conv {
  const void* x;        // int8, or fp32 / bf16 quantized on the way in
  const int8_t* w;
  int n, h, wd, ci, co, k, stride, pad, ho, wo;
  long long m;          // n * ho * wo
  int kdim;             // k * k * ci
  int qmode;            // Quant, for a float x
  float inv;            // kQuantMul: x * inv
  const float* scale;   // kQuantDiv: x / *scale (on the device)
};

struct Epilogue {
  void* out;
  const float* scale;   // null: raw int32 sums
  const float* bias;
  const float* scale2;  // null: no second affine
  const float* bias2;
  const int32_t* addend;  // null: none
  long long addend_hw;
  long long addend_rep;
  float inv_next;
  int mode;
  int act;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const int bytes = valid ? N : 0;  // 0: the destination is zero-filled
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                     "r"(smem_addr(dst)), "l"(src), "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::
                     "r"(smem_addr(dst)), "l"(src), "n"(N), "r"(bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// The JAX package's quantize step: clamp(round(x * inv)) or clamp(round(x /
// s)), round half to even, in fp32.
__device__ __forceinline__ int8_t quantize(float x, int qmode, float q) {
  const float y = qmode == kQuantMul ? __fmul_rn(x, q) : __fdiv_rn(x, q);
  return static_cast<int8_t>(fminf(fmaxf(rintf(y), -127.f), 127.f));
}

// Thread r's im2col row: the output pixel's image and its top-left tap.
struct Row {
  bool ok;
  int img, hi0, wi0;
};

// Calls f(j, src, ok) for each VEC-wide chunk of this thread's A row in
// k-tile kt: j its byte offset in the tile's row, src its first element,
// ok false in the padding and past k^2 Ci (src is then x itself).
template <int VEC, typename IN, typename F>
__device__ __forceinline__ void walk_row(const Conv& cv, const Row& row, int kt, F&& f) {
  const IN* x = static_cast<const IN*>(cv.x);
  int kk = kt * kBK;
  const int rc = kk / cv.ci;
  int c0 = kk - rc * cv.ci;
  int tr = rc / cv.k;
  int tc = rc - tr * cv.k;
#pragma unroll 4
  for (int j = 0; j < kBK; j += VEC, kk += VEC) {
    bool ok = row.ok && kk < cv.kdim;
    const IN* src = x;
    if (ok) {
      const int hi = row.hi0 + tr, wi = row.wi0 + tc;
      ok = hi >= 0 && hi < cv.h && wi >= 0 && wi < cv.wd;
      if (ok) {
        src = x + ((static_cast<long long>(row.img) * cv.h + hi) * cv.wd + wi) * cv.ci + c0;
      }
    }
    f(j, src, ok);
    c0 += VEC;  // VEC divides Ci: a chunk never crosses a tap
    if (c0 >= cv.ci) {
      c0 = 0;
      if (++tc == cv.k) {
        tc = 0;
        ++tr;
      }
    }
  }
}

// The 32-bit words VEC elements of IN take (at least one).
template <int VEC, typename IN>
constexpr int kChunkWords = VEC * static_cast<int>(sizeof(IN)) >= 4
                                ? VEC * static_cast<int>(sizeof(IN)) / 4 : 1;

// VEC values at src (aligned to VEC of them) into a chunk's words.
template <int VEC, typename IN>
__device__ __forceinline__ void load_chunk(uint32_t* w, const IN* src) {
  if constexpr (kChunkWords<VEC, IN> >= 4) {
#pragma unroll
    for (int i = 0; i < kChunkWords<VEC, IN> / 4; ++i) {
      reinterpret_cast<uint4*>(w)[i] = __ldg(reinterpret_cast<const uint4*>(src) + i);
    }
  } else {
    reinterpret_cast<uint2*>(w)[0] = __ldg(reinterpret_cast<const uint2*>(src));
  }
}

// Element i of a loaded chunk as fp32 (bf16 is the top half of an fp32).
template <typename IN>
__device__ __forceinline__ float chunk_value(const uint32_t* w, int i) {
  if constexpr (std::is_same_v<IN, float>) {
    return __uint_as_float(w[i]);
  } else {
    const uint32_t word = w[i >> 1];
    return __uint_as_float((i & 1) ? (word & 0xffff0000u) : (word << 16));
  }
}

template <int VEC>
__device__ __forceinline__ void store_bytes(int8_t* dst, const int8_t (&q)[VEC]) {
  if constexpr (VEC == 16) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(q);
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(q);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = q[i];
  }
}

// Stage k-tile kt of this thread's A row into `dst` directly: int8 by
// cp.async (VEC 16 or 4) or byte by byte; a float x through registers,
// VEC values a load, quantized as they arrive.
template <int VEC, typename IN>
__device__ __forceinline__ void load_a(const Conv& cv, const Row& row, int8_t* dst,
                                       int kt, float q) {
  walk_row<VEC, IN>(cv, row, kt, [&](int j, const IN* src, bool ok) {
    if constexpr (!std::is_same_v<IN, int8_t>) {
      alignas(16) int8_t out[VEC];
      if constexpr (VEC == 1) {
        out[0] = ok ? quantize(to_float(src[0]), cv.qmode, q) : int8_t(0);
      } else {
        alignas(16) uint32_t w[kChunkWords<VEC, IN>];
        if (ok) load_chunk<VEC, IN>(w, src);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          out[i] = ok ? quantize(chunk_value<IN>(w, i), cv.qmode, q) : int8_t(0);
        }
      }
      store_bytes<VEC>(dst + j, out);
    } else if constexpr (VEC == 1) {
      dst[j] = ok ? *src : static_cast<int8_t>(0);
    } else {
      cp_async<VEC>(dst + j, src, ok);
    }
  });
}

// Stage k-tile kt of the weight tile: row tid / 2, half tid % 2.
template <int VEC>
__device__ __forceinline__ void load_b(const Conv& cv, int8_t* sb, int kt, int n0) {
  const int tid = threadIdx.x;
  const int r = tid >> 1;
  const int half = (tid & 1) * (kBK / 2);
  const int co = n0 + r;
  int8_t* dst = sb + r * kPitch + half;
  const int8_t* base = cv.w + static_cast<long long>(co) * cv.kdim;
#pragma unroll 4
  for (int j = 0; j < kBK / 2; j += VEC) {
    const int kk = kt * kBK + half + j;
    const bool ok = co < cv.co && kk < cv.kdim;
    const int8_t* src = ok ? base + kk : cv.w;
    if constexpr (VEC == 1) {
      dst[j] = ok ? *src : static_cast<int8_t>(0);
    } else {
      cp_async<VEC>(dst + j, src, ok);
    }
  }
}

template <typename OUT>
__device__ __forceinline__ OUT zero() {
  if constexpr (std::is_same_v<OUT, bf16>) {
    return __float2bfloat16_rn(0.f);
  } else {
    return static_cast<OUT>(0);
  }
}

// The output row of the addend for output row `row`: the shared half's sum,
// once for the R parts of a row.
__device__ __forceinline__ long long addend_row(const Epilogue& ep, long long row) {
  return (row / (ep.addend_rep * ep.addend_hw)) * ep.addend_hw + row % ep.addend_hw;
}

// The epilogue's float steps on a sum (the addend already added), with
// column col's scale, bias, scale2, bias2 (read by the caller).
template <typename OUT>
__device__ __forceinline__ OUT finish_acc(const Epilogue& ep, int acc, float scale,
                                          float bias, float scale2, float bias2) {
  if constexpr (std::is_same_v<OUT, int32_t>) {
    return acc;
  } else {
    float y = __fmaf_rn(__int2float_rn(acc), scale, bias);
    if (ep.scale2 != nullptr) y = __fmaf_rn(y, scale2, bias2);
    if (ep.act == kRelu) {
      y = y > 0.f ? y : 0.f;
    } else if (ep.act == kLeaky) {
      y = y >= 0.f ? y : __fmul_rn(0.1f, y);
    }
    if constexpr (std::is_same_v<OUT, float>) {
      return y;
    } else if constexpr (std::is_same_v<OUT, bf16>) {
      return __float2bfloat16_rn(y);
    } else {
      return static_cast<int8_t>(
          fminf(fmaxf(rintf(__fmul_rn(y, ep.inv_next)), -127.f), 127.f));
    }
  }
}

// The epilogue of one output element (row, col inside the output).
template <typename OUT>
__device__ __forceinline__ OUT finish(const Epilogue& ep, long long row, int col,
                                      int co, int acc) {
  if (ep.addend != nullptr) acc += ep.addend[addend_row(ep, row) * co + col];
  if constexpr (std::is_same_v<OUT, int32_t>) {
    return acc;
  } else {
    const bool two = ep.scale2 != nullptr;
    return finish_acc<OUT>(ep, acc, ep.scale[col], ep.bias[col], two ? ep.scale2[col] : 0.f,
                           two ? ep.bias2[col] : 0.f);
  }
}

// The block's finished tile: each element's epilogue into shared memory (a
// 128 x 64 OUT tile, rows 16 bytes longer than the data), then out to the
// output row by row in 16-byte vectors (single elements where Co's rows are
// not 16-byte multiples or at Co's edge).
template <typename OUT>
__device__ __forceinline__ void write_tile(const Conv& cv, const Epilogue& ep,
                                           const int (&acc)[4][4][4], int8_t* smem,
                                           long long m0, int n0, int wm, int wn,
                                           int g, int t4) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(OUT));  // elements a vector
  constexpr int kPitchOut = kBN + kPer;
  OUT* tile = reinterpret_cast<OUT*>(smem);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wm + mt * 16 + g + (e >= 2 ? 8 : 0);
        const int c = wn + nt * 8 + t4 * 2 + (e & 1);
        const long long row = m0 + r;
        const int col = n0 + c;
        tile[r * kPitchOut + c] = (row < cv.m && col < cv.co)
            ? finish<OUT>(ep, row, col, cv.co, acc[mt][nt][e]) : zero<OUT>();
      }
    }
  }
  __syncthreads();
  constexpr int kChunks = kBN / kPer;
  const bool rows_vec = (static_cast<long long>(cv.co) * sizeof(OUT)) % 16 == 0;
  OUT* out = static_cast<OUT*>(ep.out);
  for (int idx = threadIdx.x; idx < kBM * kChunks; idx += kThreads) {
    const int r = idx / kChunks, ch = idx % kChunks;
    const long long row = m0 + r;
    const int col = n0 + ch * kPer;
    if (row >= cv.m || col >= cv.co) continue;
    const OUT* src = tile + r * kPitchOut + ch * kPer;
    OUT* dst = out + row * cv.co + col;
    if (rows_vec && col + kPer <= cv.co) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < kPer && col + e < cv.co; ++e) dst[e] = src[e];
    }
  }
}

template <int VEC, typename IN>
__global__ void __launch_bounds__(kThreads) conv_s8_kernel(Conv cv, Epilogue ep) {
  // the pipeline's A and B stages; the output tile once the sums are done
  __shared__ __align__(16) int8_t smem[kStages * (kBM + kBN) * kPitch];
  int8_t* sa[kStages];
  int8_t* sb[kStages];
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    sa[s] = smem + s * kBM * kPitch;
    sb[s] = smem + kStages * kBM * kPitch + s * kBN * kPitch;
  }
  const float q = cv.qmode == kQuantDiv ? *cv.scale : cv.inv;

  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  Row row;
  {
    const long long m = m0 + tid;
    row.ok = m < cv.m;
    row.img = row.hi0 = row.wi0 = 0;
    if (row.ok) {
      const long long hw = static_cast<long long>(cv.ho) * cv.wo;
      row.img = static_cast<int>(m / hw);
      const int rem = static_cast<int>(m - row.img * hw);
      const int oh = rem / cv.wo;
      const int ow = rem - oh * cv.wo;
      row.hi0 = oh * cv.stride - cv.pad;
      row.wi0 = ow * cv.stride - cv.pad;
    }
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 32;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int ktiles = (cv.kdim + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) {
      load_a<VEC, IN>(cv, row, sa[s] + tid * kPitch, s, q);
      load_b<VEC>(cv, sb[s], s, n0);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < ktiles) {
      load_a<VEC, IN>(cv, row, sa[next % kStages] + tid * kPitch, next, q);
      load_b<VEC>(cv, sb[next % kStages], next, n0);
    }
    cp_async_commit();

    const int8_t* a_tile = sa[kt % kStages];
    const int8_t* b_tile = sb[kt % kStages];
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int8_t* p = a_tile + (wm + mt * 16 + g) * kPitch + ks + t4 * 4;
        a[mt][0] = lds32(p);
        a[mt][1] = lds32(p + 8 * kPitch);
        a[mt][2] = lds32(p + 16);
        a[mt][3] = lds32(p + 8 * kPitch + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* p = b_tile + (wn + nt * 8 + g) * kPitch + ks + t4 * 4;
        const uint32_t b0 = lds32(p), b1 = lds32(p + 16);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma_s8(acc[mt][nt], a[mt], b0, b1);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages: reuse them
  if (ep.mode == kInt32) {
    write_tile<int32_t>(cv, ep, acc, smem, m0, n0, wm, wn, g, t4);
  } else if (ep.mode == kFloat) {
    write_tile<float>(cv, ep, acc, smem, m0, n0, wm, wn, g, t4);
  } else if (ep.mode == kBf16) {
    write_tile<bf16>(cv, ep, acc, smem, m0, n0, wm, wn, g, t4);
  } else {
    write_tile<int8_t>(cv, ep, acc, smem, m0, n0, wm, wn, g, t4);
  }
}

template <typename IN>
int launch(const Conv& cv, const Epilogue& ep, dim3 grid, int vec, cudaStream_t s) {
  if (vec == 16) {
    conv_s8_kernel<16, IN><<<grid, kThreads, 0, s>>>(cv, ep);
  } else if (vec == 4) {
    conv_s8_kernel<4, IN><<<grid, kThreads, 0, s>>>(cv, ep);
  } else if (vec == 1) {
    conv_s8_kernel<1, IN><<<grid, kThreads, 0, s>>>(cv, ep);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The quantize pass: x (rows, ci) of IN into out (rows, cp) int8, cp % 16
// == 0, channels past ci zero; int8 x copied, a float x quantized
// (`quantize`). One thread a 16-channel chunk, grid-stride.
template <typename IN>
__global__ void __launch_bounds__(256) quant_pass_kernel(const IN* x, int8_t* out,
                                                         long long rows, int ci, int cp,
                                                         int qmode, float inv,
                                                         const float* scale) {
  const float q = qmode == kQuantDiv ? *scale : inv;
  const int chunks = cp / 16;
  const long long total = rows * chunks;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long row = idx / chunks;
    const int c0 = (int)(idx - row * chunks) * 16;
    const IN* src = x + row * ci + c0;
    alignas(16) int8_t v[16];
    if (c0 + 16 <= ci && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
      if constexpr (std::is_same_v<IN, int8_t>) {
        *reinterpret_cast<uint4*>(v) = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        alignas(16) uint32_t words[kChunkWords<16, IN>];
        load_chunk<16, IN>(words, src);
#pragma unroll
        for (int e = 0; e < 16; ++e) v[e] = quantize(chunk_value<IN>(words, e), qmode, q);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        if (c0 + e >= ci) {
          v[e] = 0;
        } else if constexpr (std::is_same_v<IN, int8_t>) {
          v[e] = src[e];
        } else {
          v[e] = quantize(to_float(src[e]), qmode, q);
        }
      }
    }
    *reinterpret_cast<uint4*>(out + row * cp + c0) = *reinterpret_cast<const uint4*>(v);
  }
}

// x (rows, ci) of the library's type (x_dtype as conv_s8_entry), qmode and
// its scale as there (0 for an int8 x: a copy); out (rows, cp) int8,
// 16-byte aligned, cp % 16 == 0, cp >= ci. Returns a cudaError_t code.
template <typename IN>
int quant_pass_entry(const void* x, int x_dtype, int qmode, float in_inv,
                     const void* in_scale, void* out, long long rows, int ci, int cp,
                     void* stream) {
  constexpr int kXDtype = std::is_same_v<IN, int8_t> ? 0 : (std::is_same_v<IN, float> ? 1 : 2);
  if (x_dtype != kXDtype || rows < 1 || ci < 1 || cp < ci || cp % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 || (x_dtype == 0) != (qmode == kQuantNone) ||
      qmode < 0 || qmode > 2 || (qmode == kQuantDiv && in_scale == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long chunks = rows * (cp / 16);
  const long long blocks = std::min<long long>((chunks + 255) / 256, 132LL * 16);
  quant_pass_kernel<IN><<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const IN*>(x), static_cast<int8_t*>(out), rows, ci, cp, qmode, in_inv,
      static_cast<const float*>(in_scale));
  return (int)cudaGetLastError();
}

// x (N, H, W, Ci) contiguous: int8 (x_dtype 0), or float32 (1) / bfloat16
// (2) quantized on load with qmode 1 (x * in_inv) or 2 (x / *in_scale, an
// fp32 on the device); w (Co, k, k, Ci) int8 contiguous; out (N, Ho, Wo,
// Co) contiguous, int32 (mode 0, scale null), float32 (1), bfloat16 (2) or
// int8 (3, requantized with inv_next); scale, bias (and scale2, bias2) (Co,)
// float32 or null; addend: null, or int32 (rows, Co) read at row
// (row / (addend_rep * addend_hw)) * addend_hw + row % addend_hw; act 0
// none, 1 ReLU, 2 LeakyReLU(0.1); vec: the gather width in elements, 16 or
// 4 (Ci a multiple of it, x aligned to vec elements, w to vec bytes) or 1.
// Returns a cudaError_t code, 0 on success.
// Each of conv_s8.cu, conv_s8_bf16.cu and conv_s8_fp32.cu exports it for
// one input type, as its own library: the four of K6 build in parallel.
template <typename IN>
int conv_s8_entry(const void* x, int x_dtype, int qmode, float in_inv,
                  const void* in_scale, const void* w, void* out, const void* scale,
                  const void* bias, const void* scale2, const void* bias2,
                  const void* addend, long long addend_hw, long long addend_rep,
                  float inv_next, int n, int h, int wd, int ci, int co, int k,
                  int stride, int pad, int mode, int act, int vec, void* stream) {
  constexpr int kXDtype = std::is_same_v<IN, int8_t> ? 0 : (std::is_same_v<IN, float> ? 1 : 2);
  if (x_dtype != kXDtype) return (int)cudaErrorInvalidValue;
  if (n < 1 || h < 1 || wd < 1 || ci < 1 || co < 1 || k < 1 || stride < 1 ||
      pad < 0 || mode < 0 || mode > 3 || act < 0 || act > 2 || x_dtype < 0 ||
      x_dtype > 2) {
    return (int)cudaErrorInvalidValue;
  }
  if ((mode == kInt32) != (scale == nullptr) || (scale != nullptr && bias == nullptr) ||
      (scale2 != nullptr && (bias2 == nullptr || scale == nullptr)) ||
      (addend != nullptr && (addend_hw < 1 || addend_rep < 1))) {
    return (int)cudaErrorInvalidValue;
  }
  if ((x_dtype == 0) != (qmode == kQuantNone) || qmode < 0 || qmode > 2 ||
      (qmode == kQuantDiv && in_scale == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int ho = (h + 2 * pad - k) / stride + 1;
  const int wo = (wd + 2 * pad - k) / stride + 1;
  if (h + 2 * pad < k || wd + 2 * pad < k) return (int)cudaErrorInvalidValue;
  if ((long long)k * k * ci > (1LL << 31) / (127LL * 127LL)) {
    return (int)cudaErrorInvalidValue;  // the int32 sum could overflow
  }
  const int xsize = x_dtype == 0 ? 1 : (x_dtype == 1 ? 4 : 2);
  if (vec != 1 && (ci % vec != 0 || !aligned(x, vec * xsize) || !aligned(w, vec))) {
    return (int)cudaErrorInvalidValue;
  }
  Conv cv{x, static_cast<const int8_t*>(w), n, h, wd, ci, co, k, stride, pad, ho, wo,
          static_cast<long long>(n) * ho * wo, k * k * ci, qmode, in_inv,
          static_cast<const float*>(in_scale)};
  Epilogue ep{out, static_cast<const float*>(scale), static_cast<const float*>(bias),
              static_cast<const float*>(scale2), static_cast<const float*>(bias2),
              static_cast<const int32_t*>(addend), addend_hw, addend_rep,
              inv_next, mode, act};
  const long long mtiles = (cv.m + kBM - 1) / kBM;
  const int ntiles = (co + kBN - 1) / kBN;
  if (mtiles > 0x7fffffffLL || ntiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(mtiles), ntiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch<IN>(cv, ep, grid, vec, s);
}

}  // namespace
