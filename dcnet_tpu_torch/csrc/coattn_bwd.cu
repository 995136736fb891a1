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
// Precision follows the TPU kernel: every product, exponential and sum is
// fp32, with the *unrounded* fp32 W (the forward rounds W to bf16 before PV
// for bf16 inputs; the backward does not). dq and dkv are rounded once to
// the input dtype at the end. The products run on the tensor cores
// (mma.sync m16n8k8 TF32) by 3xTF32 (tf32x3.cuh), which keeps fp32
// accuracy: each fp32 operand is split into a TF32 big and small part in
// registers. bf16 values are exact in TF32, so with bf16 inputs S and dW
// (bf16 x bf16) take one pass and the products with an fp32 operand (dS kv,
// dS^T q, W^T g) two; fp32 inputs take three passes everywhere.
//
// Bound per call: the TPU body's five products (S, dW, dS kv, dS^T q,
// W^T g), 2*B*P^2*C operations each, at the card's fastest route that keeps
// their accuracy: bf16 x bf16 at 989 TFLOP/s, an fp32 operand by 3xTF32 at
// 495 / 3 TFLOP/s (the bound counts a bf16 x fp32 product at 989 / 3, a
// three-piece bf16 split); and 5*B*P*C*sizeof(T) bytes (q, kv, g read once;
// dq, dkv written once). At B = 16, P = 1024, C = 512 that is 0.52 ms in
// fp32 and 0.19 ms in bf16, compute-bound.
//
// Design. The TPU kernel holds each row tile's full (R, P) softmax in VMEM
// and accumulates dkv across row tiles of one resident block, which relies
// on the TPU's sequential grid. Hopper blocks run in parallel and in no
// order, and an fp32 (256, 1024) tile alone is 1 MiB, so this is the
// FlashAttention-2 split instead, deterministic (no atomics):
//   1. dq pass (q-major). A block owns kOwn rows of q and g and streams kv
//      in tiles of kStream rows twice. Sweep 1 keeps, per row, the running
//      max m, sum l and a = sum exp(S - m) dW (rescaled as m grows), which
//      gives the logsumexp L = m + log l and D = a / l = rowsum(dW * W);
//      both go to global scratch. Sweep 2 recomputes S and dW, forms
//      dS = exp(S - L) (dW - D) and accumulates dq = T dS kv.
//   2. dkv pass (kv-major). A block owns kOwn rows of kv and streams q and
//      g in tiles of kStream rows with their L and D; it computes S^T and
//      dW^T directly (kv rows against q and g rows), so that W^T and dS^T
//      are accumulator tiles, and accumulates dkv = T dS^T q + W^T g.
// That is nine products against the TPU body's five (S and dW are formed
// three times), the price of no (R, P) tile. 256 threads: 8 warps, 2 row
// groups of 16 owned rows x 4 channel groups of about C/4 channels; each
// warp keeps a 16 x C/4 fp32 accumulator in registers and takes the partial
// S and dW of its channels, which the four warps of a row group sum through
// shared memory (in channel-group order, so they hold the same values).
// (16 warps of C/8 channels, as the fp32 forward block has, ran bf16 18%
// slower and fp32 7% faster on the H100, spilling at 128 registers a
// thread.)
// Operands sit in shared memory in the input dtype with a pitch of
// C + 16 bytes (conflict-free fragment loads); the streamed tiles are
// double-buffered by cp.async. A block owns 32 rows, not 64: the owned q and
// g rows at C = 512 in fp32 are already 128 KB, and the accumulator of 64
// rows would not fit the registers of 8 warps. About 210 KB of shared memory
// in fp32 (one block per SM) and 115 KB in bf16 at C = 512. Rows and columns
// past P are masked (zero rows in, W = 0, no store), so ragged P (169 at
// 416 px) works.
//
// Widths the passes above do not take (C % 16 != 0 or C > 512; no
// configuration of the repository runs one) take K3's general pass, chosen
// by shape in the entry point, never as a fallback: the same two passes on
// the tile primitives of the general forward block (attend_wide.cuh), on
// the CUDA cores in fp32. A block owns 32 rows and one output chunk of at
// most 512 channels (a grid dimension); S and dW (dkv pass: S^T and dW^T)
// need all of C, so each 32 x 32 tile of both is summed over C in chunks
// of 32 channels staged through shared memory, once per output chunk. Each
// global load is one element wide and masked (channels past C are zero,
// which adds 0 to S and dW and gives zero columns in dq and dkv), so rows
// need no alignment. The dq pass keeps L (natural log) and D per row in
// the same scratch; its chunk 0 writes them. Shared memory (157 KB at
// C > 256) is checked against the 232,448 B limit before the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attend_wide.cuh"
#include "tf32x3.cuh"

namespace {

using namespace dcnet::tf32;
namespace wide = dcnet::wide;

constexpr int kGroups = 4;               // channel groups
constexpr int kWarps = 2 * kGroups;      // 2 row groups of 16 rows x kGroups
constexpr int kThreads = 32 * kWarps;
constexpr int kOwn = 32;                 // rows a block owns
constexpr int kStream = 16;              // streamed rows per tile
constexpr int kMaxC = 512;
constexpr int kMaxOwn = kMaxC / (8 * kGroups);  // n8 channel tiles a warp owns, at most
constexpr int kXch = kWarps * 2 * 2 * 32;       // float4: [warp][S, dW][n8][lane]

// The widths of the two 3xTF32 passes: C % 16 == 0, C <= 512.
inline bool tf32_takes(int C) { return C % 16 == 0 && C >= 16 && C <= kMaxC; }

__host__ __device__ inline size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

// Pitch in elements: 16 bytes past C.
template <typename T>
__host__ __device__ inline int pitch(int C) {
  return C + 16 / (int)sizeof(T);
}

// Both passes: the owned rows (two matrices in the dq pass, one in the dkv
// pass) and two stages of streamed tiles (one matrix in the dq pass, two in
// the dkv pass): three matrices of kOwn rows' size either way, the exchange,
// and the dkv pass's L and D of two stages.
template <typename T>
__host__ __device__ inline size_t smem_bytes(int C) {
  static_assert(kOwn == 2 * kStream, "the passes share one layout size");
  return align128(sizeof(T) * 3 * kOwn * pitch<T>(C)) + sizeof(float4) * kXch +
         sizeof(float) * 4 * kStream;
}

__device__ inline void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ inline void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The partial products of this warp's channels for one tile: x = A B1^T and
// y = A2 B2^T, 16 owned rows x 16 streamed rows, where A1, A2 are the owned
// rows at `a1`, `a2` and B1, B2 the streamed rows at `b1`, `b2` (all at the
// warp's first channel). Then summed over the four channel groups through
// `xch`, after a __syncthreads. Where a2 == a1 (the dkv pass: kv against q
// and g) or b2 == b1 (the dq pass: q and g against kv) one fragment serves
// both products.
template <typename T>
__device__ __forceinline__ void scores(const T* a1, const T* a2, const T* b1,
                                       const T* b2, int ld, int count,
                                       float4* xch, float (&x)[2][4],
                                       float (&y)[2][4]) {
  constexpr bool kSmall = !kExact<T>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, rg = warp & 1;
  float ex[2][4], ey[2][4];  // the small-part terms
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[n][j] = y[n][j] = ex[n][j] = ey[n][j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kMaxOwn; ++i) {
    if (i < count) {
      FragA fa1, fa2;
      load_a(fa1, a1 + 8 * i, ld, lane);
      if (a2 == a1) {
        fa2 = fa1;
      } else {
        load_a(fa2, a2 + 8 * i, ld, lane);
      }
      FragB fb1[2], fb2[2];
      load_b_k2(fb1[0], fb1[1], b1 + 8 * i, ld, lane);
      if (b2 == b1) {
        fb2[0] = fb1[0];
        fb2[1] = fb1[1];
      } else {
        load_b_k2(fb2[0], fb2[1], b2 + 8 * i, ld, lane);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        mma3<kSmall, kSmall>(x[n], ex[n], fa1, fb1[n]);
        mma3<kSmall, kSmall>(y[n], ey[n], fa2, fb2[n]);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    xch[((warp * 2 + 0) * 2 + n) * 32 + lane] = make_float4(
        x[n][0] + ex[n][0], x[n][1] + ex[n][1], x[n][2] + ex[n][2], x[n][3] + ex[n][3]);
    xch[((warp * 2 + 1) * 2 + n) * 32 + lane] = make_float4(
        y[n][0] + ey[n][0], y[n][1] + ey[n][1], y[n][2] + ey[n][2], y[n][3] + ey[n][3]);
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    float4 u = xch[((rg * 2 + 0) * 2 + n) * 32 + lane];  // channel group 0
    float4 v = xch[((rg * 2 + 1) * 2 + n) * 32 + lane];
#pragma unroll
    for (int c = 1; c < kGroups; ++c) {
      const int w = rg + 2 * c;
      const float4 du = xch[((w * 2 + 0) * 2 + n) * 32 + lane];
      const float4 dv = xch[((w * 2 + 1) * 2 + n) * 32 + lane];
      u.x += du.x; u.y += du.y; u.z += du.z; u.w += du.w;
      v.x += dv.x; v.y += dv.y; v.z += dv.z; v.w += dv.w;
    }
    x[n][0] = u.x; x[n][1] = u.y; x[n][2] = u.z; x[n][3] = u.w;
    y[n][0] = v.x; y[n][1] = v.y; y[n][2] = v.z; y[n][3] = v.w;
  }
}

// acc (16 x own channels) += A B for the 16 streamed rows of a tile: A from
// the accumulator tiles a[2] (16 x 16), B the streamed rows at `b` (the
// warp's first channel). B has a small part for fp32 inputs.
//
// The tensor cores add each product to the fp32 accumulator they are given
// and truncate the sum. Chained over the whole stream (three passes, two
// 8-steps, P / 16 tiles: 384 products at P = 1024) that drifts: fp32 K3 sat
// 1.44e-5 (relative) from float64, the plain fp32 version 6.4e-7. So for
// fp32 inputs the tile's products are summed from zero and added to acc by
// an fp32 add (round to nearest): the truncation then acts on one tile's
// sum. bf16 inputs keep the chained sum; the extra adds cost bf16 K3 15%
// (3.13 -> 3.61 ms at B = 16, P = 1024, C = 512 on the H100), and the bf16
// output's rounding is far above the drift.
template <typename T>
__device__ __forceinline__ void accumulate(float (&acc)[kMaxOwn][4],
                                           const float (&a)[2][4], const T* b,
                                           int ld, int count) {
  const int lane = threadIdx.x % 32;
  if constexpr (kExact<T>) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      FragA fa;
      acc_to_a(fa, a[k]);
#pragma unroll
      for (int i = 0; i < kMaxOwn; ++i) {
        if (i < count) {
          FragB fb;
          load_b_n(fb, b + 8 * k * ld + 8 * i, ld, lane);
          mma3<true, false>(acc[i], fa, fb);
        }
      }
    }
  } else {
    FragA fa[2];
    acc_to_a(fa[0], a[0]);
    acc_to_a(fa[1], a[1]);
#pragma unroll
    for (int i = 0; i < kMaxOwn; ++i) {
      if (i < count) {
        float tile[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          FragB fb;
          load_b_n(fb, b + 8 * k * ld + 8 * i, ld, lane);
          mma3<true, true>(tile, fa[k], fb);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += tile[j];
      }
    }
  }
}

// Rows row0 + 16 rg + g (and + 8) of a (P, C) output, this warp's channels,
// scaled by `scale`, rounded to T; rows past P are not stored.
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[kMaxOwn][4],
                                           float scale, int row0, int P, int C,
                                           int c0, int count) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = row0 + 16 * (warp & 1) + lane / 4;
  T* p = dst + (long long)r * C + c0 + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < kMaxOwn; ++i) {
    if (i < count) {
      if (r < P) store2(p + 8 * i, scale * acc[i][0], scale * acc[i][1]);
      if (r + 8 < P) store2(p + 8 * C + 8 * i, scale * acc[i][2], scale * acc[i][3]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ kv,
              const T* __restrict__ g, T* __restrict__ dq,
              float* __restrict__ lse, float* __restrict__ dd, int P, int C,
              long long q_bstride, long long kv_bstride, long long g_bstride,
              float t) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = pitch<T>(C);
  T* q_s = reinterpret_cast<T*>(smem);
  T* g_s = q_s + kOwn * ld;
  T* kv_s = g_s + kOwn * ld;  // stage s at kv_s + s * kStream * ld
  float4* xch = reinterpret_cast<float4*>(smem + align128(sizeof(T) * 3 * kOwn * ld));

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kOwn;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, rg = warp & 1;
  const Channels ch = channel_group(warp >> 1, kGroups, C);
  const int c0 = 8 * ch.first;
  const T* kvb = kv + (long long)b * kv_bstride;
  const int tiles = (P + kStream - 1) / kStream;
  const float scale = t * kLog2e;  // logits in the log2 domain
  const T* qw = q_s + 16 * rg * ld + c0;
  const T* gw = g_s + 16 * rg * ld + c0;

  load_rows_async(q_s, ld, q + (long long)b * q_bstride, row0, kOwn, P, C, kThreads);
  load_rows_async(g_s, ld, g + (long long)b * g_bstride, row0, kOwn, P, C, kThreads);

  // Two sweeps over the kv tiles; `body(it, kv tile)` runs between the
  // tile's arrival and the next tile's copy.
  auto sweep = [&](auto body) {
    __syncthreads();  // the last sweep's readers of stage 0 are done
    load_rows_async(kv_s, ld, kvb, 0, kStream, P, C, kThreads);
    cp_async_commit();
    for (int it = 0; it < tiles; ++it) {
      __syncthreads();  // every warp is done with tile it-1's stage and the exchange
      if (it + 1 < tiles) {
        load_rows_async(kv_s + ((it + 1) & 1) * kStream * ld, ld, kvb,
                        (it + 1) * kStream, kStream, P, C, kThreads);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      body(it, kv_s + (it & 1) * kStream * ld);
    }
  };
  float s[2][4], dw[2][4];

  // sweep 1: logsumexp and D per row (rows g and g + 8), online
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, a0 = 0.f, a1 = 0.f;
  sweep([&](int it, const T* kvt) {
    scores(qw, gw, kvt + c0, kvt + c0, ld, ch.count, xch, s, dw);
    const int col0 = it * kStream + 2 * (lane & 3);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[n][j] = col0 + 8 * n + (j & 1) < P ? s[n][j] * scale : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));  // finite: column it*16 < P
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);  // 0 at first
    float e0 = 0.f, e1 = 0.f, d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float u = exp2f(s[n][j] - mn0), v = exp2f(s[n][j + 2] - mn1);
        e0 += u;
        d0 += u * dw[n][j];
        e1 += v;
        d1 += v * dw[n][j + 2];
      }
    }
    l0 = l0 * alpha0 + quad_sum(e0);
    l1 = l1 * alpha1 + quad_sum(e1);
    a0 = a0 * alpha0 + quad_sum(d0);
    a1 = a1 * alpha1 + quad_sum(d1);
    m0 = mn0;
    m1 = mn1;
  });
  const float lse0 = m0 + log2f(l0), lse1 = m1 + log2f(l1);  // log2 domain
  const float dd0 = a0 / l0, dd1 = a1 / l1;
  const int r = row0 + 16 * rg + lane / 4;
  if (warp < 2 && (lane & 3) == 0) {  // channel group 0 writes L and D
    if (r < P) {
      lse[(long long)b * P + r] = lse0;
      dd[(long long)b * P + r] = dd0;
    }
    if (r + 8 < P) {
      lse[(long long)b * P + r + 8] = lse1;
      dd[(long long)b * P + r + 8] = dd1;
    }
  }

  // sweep 2: dq = T dS kv
  float acc[kMaxOwn][4];
#pragma unroll
  for (int i = 0; i < kMaxOwn; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  sweep([&](int it, const T* kvt) {
    scores(qw, gw, kvt + c0, kvt + c0, ld, ch.count, xch, s, dw);
    const int col0 = it * kStream + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool lo = j < 2;
        const float w = col0 + 8 * n + (j & 1) < P
                            ? exp2f(s[n][j] * scale - (lo ? lse0 : lse1)) : 0.f;
        s[n][j] = w * (dw[n][j] - (lo ? dd0 : dd1));
      }
    }
    accumulate(acc, s, kvt + c0, ld, ch.count);
  });
  store_rows(dq + (long long)b * P * C, acc, t, row0, P, C, c0, ch.count);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ kv,
               const T* __restrict__ g, T* __restrict__ dkv,
               const float* __restrict__ lse, const float* __restrict__ dd,
               int P, int C, long long q_bstride, long long kv_bstride,
               long long g_bstride, float t) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = pitch<T>(C);
  T* kv_s = reinterpret_cast<T*>(smem);
  T* st_s = kv_s + kOwn * ld;  // stage s: q rows, then g rows, kStream each
  float4* xch = reinterpret_cast<float4*>(smem + align128(sizeof(T) * 3 * kOwn * ld));
  float* ld_s = reinterpret_cast<float*>(xch + kXch);  // stage s: L, then D

  const int b = blockIdx.y;
  const int col0 = blockIdx.x * kOwn;  // the kv rows this block owns
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, rg = warp & 1;
  const Channels ch = channel_group(warp >> 1, kGroups, C);
  const int c0 = 8 * ch.first;
  const T* qb = q + (long long)b * q_bstride;
  const T* gb = g + (long long)b * g_bstride;
  const float* lseb = lse + (long long)b * P;
  const float* ddb = dd + (long long)b * P;
  const int tiles = (P + kStream - 1) / kStream;
  const float scale = t * kLog2e;
  const T* kw = kv_s + 16 * rg * ld + c0;

  // tile it's q and g rows into stage it & 1 (asynchronous) with their L
  // and D (plain loads: visible after the next __syncthreads)
  auto fetch = [&](int it) {
    T* st = st_s + (it & 1) * 2 * kStream * ld;
    const int r0 = it * kStream;
    load_rows_async(st, ld, qb, r0, kStream, P, C, kThreads);
    load_rows_async(st + kStream * ld, ld, gb, r0, kStream, P, C, kThreads);
    if (threadIdx.x < 2 * kStream) {
      const int i = threadIdx.x % kStream, which = threadIdx.x / kStream;
      const bool ok = r0 + i < P;
      ld_s[(it & 1) * 2 * kStream + which * kStream + i] =
          ok ? (which ? ddb : lseb)[r0 + i] : 0.f;
    }
  };
  load_rows_async(kv_s, ld, kv + (long long)b * kv_bstride, col0, kOwn, P, C, kThreads);
  fetch(0);
  cp_async_commit();

  float acc[kMaxOwn][4];
#pragma unroll
  for (int i = 0; i < kMaxOwn; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float s[2][4], dw[2][4];
  for (int it = 0; it < tiles; ++it) {
    __syncthreads();  // every warp is done with tile it-1's stage and the exchange
    if (it + 1 < tiles) fetch(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* qt = st_s + (it & 1) * 2 * kStream * ld;
    const T* gt = qt + kStream * ld;
    const float* l_t = ld_s + (it & 1) * 2 * kStream;
    const float* d_t = l_t + kStream;
    // S^T and dW^T: owned kv rows (g, g + 8) x streamed rows (columns)
    scores(kw, kw, qt + c0, gt + c0, ld, ch.count, xch, s, dw);
    const int rr0 = 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rr = rr0 + 8 * n + (j & 1);
        const float w = it * kStream + rr < P ? exp2f(s[n][j] * scale - l_t[rr]) : 0.f;
        s[n][j] = w;                                  // W^T
        dw[n][j] = t * w * (dw[n][j] - d_t[rr]);      // T dS^T
      }
    }
    accumulate(acc, dw, qt + c0, ld, ch.count);
    accumulate(acc, s, gt + c0, ld, ch.count);
  }
  store_rows(dkv + (long long)b * P * C, acc, 1.f, col0, P, C, c0, ch.count);
}

// --- the general pass: any C ------------------------------------------------

// dq pass: rows row0.. of q and g against every kv tile, output chunk
// blockIdx.z. Sweep 1: per row the running max m, sum l and a = sum
// exp(S - m) dW, so L = m + log l and D = a / l (chunk 0 writes them);
// sweep 2: dq = T (exp(S - L) (dW - D)) kv[:, chunk].
template <typename T, int NC>
__global__ void __launch_bounds__(wide::kThreads, 1)
bwd_wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                   const T* __restrict__ g, T* __restrict__ dq,
                   float* __restrict__ lse, float* __restrict__ dd, int P, int C,
                   long long q_bstride, long long kv_bstride, long long g_bstride,
                   float t) {
  extern __shared__ __align__(128) unsigned char smem[];
  const wide::Layout L = wide::layout<T>(NC, 2);
  float* a_s = reinterpret_cast<float*>(smem + L.a);
  float* b_s = reinterpret_cast<float*>(smem + L.b);
  float* w_s = reinterpret_cast<float*>(smem + L.p);
  float* v_s = reinterpret_cast<float*>(smem + L.v);
  const long long b = blockIdx.y;
  const int row0 = blockIdx.x * wide::kRows, ch0 = blockIdx.z * NC;
  const int r = wide::dot_row(), cq = wide::dot_col();
  const T* kvb = kv + b * kv_bstride;
  const T* const lhs[2] = {q + b * q_bstride, g + b * g_bstride};
  const T* const rhs[2] = {kvb, kvb};
  float sd[2][4];  // S and dW of this thread's row and 4 columns

  float m = -INFINITY, l = 0.f, a = 0.f;  // the same in the row's 8 lanes
  for (int n0 = 0; n0 < P; n0 += wide::kTile) {
    wide::tile_dots<2>(sd, lhs, row0, rhs, n0, P, C, a_s, b_s);
    float v[4], mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = n0 + cq + 8 * j < P ? sd[0][j] * t : -INFINITY;
      mx = fmaxf(mx, v[j]);
    }
    const float mn = fmaxf(m, wide::row8_max(mx));  // finite: column n0 < P
    const float alpha = expf(m - mn);                 // 0 on the first tile
    float e = 0.f, d = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x = expf(v[j] - mn);
      e += x;
      d += x * sd[1][j];
    }
    l = l * alpha + wide::row8_sum(e);
    a = a * alpha + wide::row8_sum(d);
    m = mn;
  }
  const float lse_r = m + logf(l), dd_r = a / l;
  if (blockIdx.z == 0 && cq == 0 && row0 + r < P) {
    lse[b * P + row0 + r] = lse_r;
    dd[b * P + row0 + r] = dd_r;
  }

  float acc[8][NC / 64];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int k = 0; k < NC / 64; ++k) acc[i][k] = 0.f;
  }
  for (int n0 = 0; n0 < P; n0 += wide::kTile) {
    wide::tile_dots<2>(sd, lhs, row0, rhs, n0, P, C, a_s, b_s);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float w = n0 + cq + 8 * j < P ? expf(sd[0][j] * t - lse_r) : 0.f;
      w_s[r * wide::kPitch + cq + 8 * j] = w * (sd[1][j] - dd_r);  // dS
    }
    wide::stage_pv<NC>(v_s, kvb, n0, ch0, P, C);
    __syncthreads();
    wide::pv_accumulate<NC>(acc, w_s, v_s);
  }
  wide::store_rows<NC>(dq + b * P * C, acc, t, row0, ch0, P, C);
}

// dkv pass: owned kv rows col0.. against every q and g tile with their L
// and D, output chunk blockIdx.z: S^T and dW^T as tiles, W^T = exp(S^T - L),
// dkv = T (W^T (dW^T - D)) q[:, chunk] + W^T g[:, chunk].
template <typename T, int NC>
__global__ void __launch_bounds__(wide::kThreads, 1)
bwd_wide_dkv_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                    const T* __restrict__ g, T* __restrict__ dkv,
                    const float* __restrict__ lse, const float* __restrict__ dd,
                    int P, int C, long long q_bstride, long long kv_bstride,
                    long long g_bstride, float t) {
  extern __shared__ __align__(128) unsigned char smem[];
  const wide::Layout L = wide::layout<T>(NC, 2);
  float* a_s = reinterpret_cast<float*>(smem + L.a);
  float* b_s = reinterpret_cast<float*>(smem + L.b);
  float* w_s = reinterpret_cast<float*>(smem + L.p);  // T dS^T, then W^T
  float* v_s = reinterpret_cast<float*>(smem + L.v);  // q chunk, then g chunk
  float* cols = reinterpret_cast<float*>(smem + L.cols);  // L, then D of the tile
  const long long b = blockIdx.y;
  const int col0 = blockIdx.x * wide::kRows, ch0 = blockIdx.z * NC;
  const int r = wide::dot_row(), cq = wide::dot_col();
  const T* kvb = kv + b * kv_bstride;
  const T* qb = q + b * q_bstride;
  const T* gb = g + b * g_bstride;
  const T* const lhs[2] = {kvb, kvb};
  const T* const rhs[2] = {qb, gb};
  float sd[2][4];  // S^T and dW^T of this thread's owned row and 4 columns
  float acc[8][NC / 64];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int k = 0; k < NC / 64; ++k) acc[i][k] = 0.f;
  }
  for (int n0 = 0; n0 < P; n0 += wide::kTile) {
    // L and D of the tile's rows (the last tile's readers passed the
    // __syncthreads before its products; tile_dots' syncs publish these)
    if (threadIdx.x < 2 * wide::kTile) {
      const int i = threadIdx.x % wide::kTile, which = threadIdx.x / wide::kTile;
      cols[threadIdx.x] = n0 + i < P ? (which ? dd : lse)[b * P + n0 + i] : 0.f;
    }
    wide::tile_dots<2>(sd, lhs, col0, rhs, n0, P, C, a_s, b_s);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = cq + 8 * j;
      const float w = n0 + c < P ? expf(sd[0][j] * t - cols[c]) : 0.f;
      w_s[r * wide::kPitch + c] = t * w * (sd[1][j] - cols[wide::kTile + c]);
      w_s[(wide::kRows + r) * wide::kPitch + c] = w;
    }
    wide::stage_pv<NC>(v_s, qb, n0, ch0, P, C);
    wide::stage_pv<NC>(v_s + wide::kTile * NC, gb, n0, ch0, P, C);
    __syncthreads();
    wide::pv_accumulate<NC>(acc, w_s, v_s);
    wide::pv_accumulate<NC>(acc, w_s + wide::kRows * wide::kPitch, v_s + wide::kTile * NC);
  }
  wide::store_rows<NC>(dkv + b * P * C, acc, 1.f, col0, ch0, P, C);
}

template <typename T, int NC>
int launch_wide_nc(const void* q, const void* kv, const void* g, void* dq, void* dkv,
                   float* lse, float* dd, int B, int P, int C, long long q_bstride,
                   long long kv_bstride, long long g_bstride, float t,
                   cudaStream_t stream) {
  const size_t bytes = wide::layout<T>(NC, 2).total;
  int err = dcnet::prepare_smem(bwd_wide_dq_kernel<T, NC>, bytes);
  if (err == 0) err = dcnet::prepare_smem(bwd_wide_dkv_kernel<T, NC>, bytes);
  if (err != 0) return err;
  const dim3 grid((P + wide::kRows - 1) / wide::kRows, B, wide::chunks(C));
  bwd_wide_dq_kernel<T, NC><<<grid, wide::kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv), static_cast<const T*>(g),
      static_cast<T*>(dq), lse, dd, P, C, q_bstride, kv_bstride, g_bstride, t);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bwd_wide_dkv_kernel<T, NC><<<grid, wide::kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv), static_cast<const T*>(g),
      static_cast<T*>(dkv), lse, dd, P, C, q_bstride, kv_bstride, g_bstride, t);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wide(const void* q, const void* kv, const void* g, void* dq, void* dkv,
                float* lse, float* dd, int B, int P, int C, long long q_bstride,
                long long kv_bstride, long long g_bstride, float t, cudaStream_t s) {
  return wide::with_chunk(C, [&](auto nc) {
    return launch_wide_nc<T, decltype(nc)::value>(q, kv, g, dq, dkv, lse, dd, B, P, C,
                                                  q_bstride, kv_bstride, g_bstride, t, s);
  });
}

template <typename T>
int launch(const void* q, const void* kv, const void* g, void* dq, void* dkv,
           float* lse, float* dd, int B, int P, int C, long long q_bstride,
           long long kv_bstride, long long g_bstride, float t,
           cudaStream_t stream) {
  if (!tf32_takes(C)) {
    return launch_wide<T>(q, kv, g, dq, dkv, lse, dd, B, P, C, q_bstride, kv_bstride,
                          g_bstride, t, stream);
  }
  const size_t bytes = smem_bytes<T>(C);
  int perr = dcnet::prepare_smem(bwd_dq_kernel<T>, bytes);
  if (perr == 0) perr = dcnet::prepare_smem(bwd_dkv_kernel<T>, bytes);
  if (perr != 0) return perr;
  const dim3 grid((P + kOwn - 1) / kOwn, B);
  bwd_dq_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv),
      static_cast<const T*>(g), static_cast<T*>(dq), lse, dd, P, C,
      q_bstride, kv_bstride, g_bstride, t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dkv_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv),
      static_cast<const T*>(g), static_cast<T*>(dkv), lse, dd, P, C,
      q_bstride, kv_bstride, g_bstride, t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The pass K3 takes for width C, by shape: 2 = the 3xTF32 passes (C % 16
// == 0, C <= 512), 3 = the general pass (every other C >= 1); -1 for C < 1.
int dcnet_coattn_bwd_block(int C) {
  return C < 1 ? -1 : tf32_takes(C) ? 2 : 3;
}

// dtype: 0 = float32, 1 = bfloat16. q, kv, g: (B, P, C) with contiguous rows
// and the given batch strides (elements); dq, dkv: contiguous (B, P, C) in
// the same dtype; lse, dd: fp32 (B, P) scratch. Returns a cudaError_t code,
// 0 on success.
int dcnet_coattn_attend_bwd(const void* q, const void* kv, const void* g,
                            void* dq, void* dkv, void* lse, void* dd, int B,
                            int P, int C, long long q_bstride,
                            long long kv_bstride, long long g_bstride, float t,
                            int dtype, void* stream) {
  if (B <= 0 || P <= 0 || C <= 0 || B > 65535) {
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
    return launch<__nv_bfloat16>(q, kv, g, dq, dkv, l, d, B, P, C, q_bstride,
                                 kv_bstride, g_bstride, t, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* dcnet_coattn_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
