// The general co-attention block: every width C >= 1 that the other blocks
// do not take, in every input dtype (fp32, bf16, int8 rings), for K1/K2
// (coattn.cu) and K4 (coattn_ring.cu); its tile primitives also serve K3's
// general pass (coattn_bwd.cu). The JAX package runs its co-attention at
// any --emb_size; these are the port's kernels for the widths no
// configuration of the repository runs (C % 16 != 0, fp32 or int8 past 512,
// bf16 past the WMMA block's shared memory). Chosen by shape
// (blocks.cuh), never as a fallback.
//
// Design. The logits need the whole of C; the outputs do not. A block owns
// kRows = 32 q rows and one chunk of at most 512 output channels (NC, the
// grid's chunk dimension: C = 1056 runs three chunks, each recomputing the
// logits, a price paid only at widths off every path). It streams kv in
// tiles of kTile = 32 rows twice: the first sweep takes each row's max and
// softmax sum, the second the normalised weights and PV, so the weights
// are rounded once, after normalisation, as the TPU body rounds them:
//   1. logits: each 32 x 32 tile is summed over C in chunks of kK = 32
//      channels staged through shared memory (q and kv chunks), 4 logits a
//      thread on the CUDA cores: fp32 sums of the fp32 or bf16 values (a
//      bf16 product is exact in fp32), exact int32 sums for int8 rings,
//      converted by __int2float_rn (XLA's astype) and scaled by T/127^2;
//   2. the softmax, 8 lanes a row, the weights rounded to bf16 for bf16
//      and int8 inputs (the TPU body's cast before PV);
//   3. PV: the tile's kv rows of the block's output chunk in shared memory
//      as fp32 (int8: bf16(bf16(v) * bf16(1/127)), the TPU body's
//      dequantisation), 8 rows x NC/64 channels of fp32 accumulator a
//      thread in registers.
// Odd widths: every global load is one element wide and masked, channels
// past C read as zero (a zero channel adds 0 to every logit and gives a
// zero output column), so rows need no alignment. Rows and columns past P
// are masked (zero rows in, -inf logits, no store). Shared memory is sized
// by `layout`, which the host checks against kSmemLimit before launching.
// Bound: the same as K1's (coattn.cu); this block runs on the CUDA cores
// (fp32 FMA, 67 TFLOP/s on the H100), so it cannot come near the
// tensor-core bound, and it gives up that speed for any width.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "smem.cuh"

namespace dcnet {

namespace wide {

using bf16 = __nv_bfloat16;

constexpr int kRows = 32;     // q rows of a block (or owned rows of K3's passes)
constexpr int kTile = 32;     // streamed rows of a tile
constexpr int kK = 32;        // channels of one logit chunk
constexpr int kPitch = kK + 1;
constexpr int kThreads = 256;

// The output chunk of a width: the smallest of 64, 128, 256, 512 that
// holds C, else 512.
__host__ __device__ inline int chunk(int C) {
  return C <= 64 ? 64 : C <= 128 ? 128 : C <= 256 ? 256 : 512;
}

__host__ __device__ inline int chunks(int C) {
  return (C + chunk(C) - 1) / chunk(C);
}

// f(std::integral_constant<int, chunk(C)>{}): a launcher instantiated for
// the width's output chunk.
template <typename F>
inline int with_chunk(int C, F f) {
  switch (chunk(C)) {
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return f(std::integral_constant<int, 512>{});
  }
}

// The logit sum type: exact int32 for int8, fp32 otherwise.
template <typename T>
struct AccOf {
  using type = float;
};
template <>
struct AccOf<int8_t> {
  using type = int;
};

__device__ __forceinline__ float load_acc(const float* p) { return *p; }
__device__ __forceinline__ float load_acc(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ int load_acc(const int8_t* p) { return (int)*p; }

// The value PV reads: fp32 as it is, bf16 widened, int8 dequantised as the
// TPU body does, bf16(bf16(v) * bf16(1/127)).
__device__ __forceinline__ float load_pv(const float* p) { return *p; }
__device__ __forceinline__ float load_pv(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load_pv(const int8_t* p) {
  const float kscale = __bfloat162float(__float2bfloat16(1.0f / 127.0f));
  return __bfloat162float(__float2bfloat16((float)*p * kscale));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(int v) { return __int2float_rn(v); }

// Weights as PV reads them: rounded to bf16 for bf16 and int8 inputs.
template <typename T>
__device__ __forceinline__ float round_weight(float w) {
  if constexpr (sizeof(T) == 4) {
    return w;
  } else {
    return __bfloat162float(__float2bfloat16(w));
  }
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16(v); }

// Shared memory of a block that sums `pairs` logit tiles at once (1 or 2)
// and reads `pairs` PV operands of NC channels per tile: the operand
// chunks, the weights, the PV tiles and two rows of per-column values
// (K3's L and D).
struct Layout {
  size_t a, b, p, v, cols, total;
};

template <typename T>
__host__ __device__ inline Layout layout(int NC, int pairs) {
  using Acc = typename AccOf<T>::type;
  Layout L;
  size_t off = 0;
  L.a = off;     off += sizeof(Acc) * pairs * kRows * kPitch;
  L.b = off;     off += sizeof(Acc) * pairs * kTile * kPitch;
  L.p = off;     off += sizeof(float) * pairs * kRows * kPitch;
  L.v = off;     off += sizeof(float) * pairs * kTile * NC;
  L.cols = off;  off += sizeof(float) * 2 * kTile;
  L.total = off;
  return L;
}

// Row and first column of this thread's 4 logits in a 32 x 32 tile: row
// tid / 8, columns cq + 8 j (j < 4), cq = tid % 8; the 8 lanes of a row are
// adjacent, so row reductions are xor shuffles by 1, 2 and 4.
__device__ __forceinline__ int dot_row() { return threadIdx.x / 8; }
__device__ __forceinline__ int dot_col() { return threadIdx.x % 8; }

__device__ __forceinline__ float row8_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}

__device__ __forceinline__ float row8_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

// Stages a 32 x kK chunk (rows row0.., channels k0..) of a (P, C) frame as
// the sum type; rows past P and channels past C are zero.
template <typename T, typename Acc>
__device__ __forceinline__ void stage_chunk(Acc* dst, const T* src, int row0, int k0,
                                            int P, int C) {
  for (int i = threadIdx.x; i < 32 * kK; i += kThreads) {
    const int r = i / kK, c = i % kK;
    Acc v = 0;
    if (row0 + r < P && k0 + c < C) v = load_acc(src + (long long)(row0 + r) * C + k0 + c);
    dst[r * kPitch + c] = v;
  }
}

// out[i][j] = <A_i[ra + row], B_i[rb + col j]> over all C, for the tile of
// `pairs` products A_i B_i^T (this thread's row and 4 columns, dot_row /
// dot_col). Begins with a __syncthreads (the last readers of the staged
// chunks are done) and leaves the chunks in shared memory.
template <int kPairs, typename T, typename Acc>
__device__ __forceinline__ void tile_dots(Acc (&out)[kPairs][4], const T* const (&a)[kPairs],
                                          int ra, const T* const (&b)[kPairs], int rb,
                                          int P, int C, Acc* a_s, Acc* b_s) {
  const int r = dot_row(), cq = dot_col();
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = 0;
  }
  for (int k0 = 0; k0 < C; k0 += kK) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      stage_chunk(a_s + i * kRows * kPitch, a[i], ra, k0, P, C);
      stage_chunk(b_s + i * kTile * kPitch, b[i], rb, k0, P, C);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const Acc* ar = a_s + i * kRows * kPitch + r * kPitch;
      const Acc* bt = b_s + i * kTile * kPitch + cq * kPitch;
#pragma unroll 8
      for (int kk = 0; kk < kK; ++kk) {
        const Acc x = ar[kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) out[i][j] += x * bt[8 * j * kPitch + kk];
      }
    }
  }
}

// Stages rows row0.. of channels ch0..ch0+NC of a (P, C) frame as the
// values PV reads (fp32); rows past P and channels past C are zero.
template <int NC, typename T>
__device__ __forceinline__ void stage_pv(float* dst, const T* src, int row0, int ch0,
                                         int P, int C) {
  for (int i = threadIdx.x; i < kTile * NC; i += kThreads) {
    const int r = i / NC, c = i % NC;
    float v = 0.f;
    if (row0 + r < P && ch0 + c < C) v = load_pv(src + (long long)(row0 + r) * C + ch0 + c);
    dst[i] = v;
  }
}

// acc (this thread's 8 rows x NC/64 channels) += W V over a tile's 32
// streamed rows: W (32 x 32, pitch kPitch) and V (32 x NC) in shared
// memory. Rows 8 (tid / 64) + i, channels tid % 64 + 64 k.
template <int NC>
__device__ __forceinline__ void pv_accumulate(float (&acc)[8][NC / 64], const float* w_s,
                                              const float* v_s) {
  const int rg = threadIdx.x / 64, cg = threadIdx.x % 64;
#pragma unroll 4
  for (int j = 0; j < kTile; ++j) {
    float v[NC / 64];
#pragma unroll
    for (int k = 0; k < NC / 64; ++k) v[k] = v_s[j * NC + cg + 64 * k];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float w = w_s[(8 * rg + i) * kPitch + j];
#pragma unroll
      for (int k = 0; k < NC / 64; ++k) acc[i][k] += w * v[k];
    }
  }
}

// Rows row0 + 8 (tid / 64) + i, channels ch0 + tid % 64 + 64 k of a (P, C)
// output frame: scale * acc; rows past P and channels past C are not
// stored.
template <int NC, typename OutT>
__device__ __forceinline__ void store_rows(OutT* ob, const float (&acc)[8][NC / 64],
                                           float scale, int row0, int ch0, int P,
                                           int C) {
  const int rg = threadIdx.x / 64, cg = threadIdx.x % 64;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + 8 * rg + i;
    if (r >= P) continue;
#pragma unroll
    for (int k = 0; k < NC / 64; ++k) {
      const int c = ch0 + cg + 64 * k;
      if (c < C) store_out(ob + (long long)r * C + c, acc[i][k] * scale);
    }
  }
}

// The block's whole computation: rows row0..row0+31 of the (P, C) frame qb
// against every row of the (P, C) frame kvb, output channels ch0..ch0+NC,
// written to the (P, C) frame ob. `t` scales the logits (T, or T/127^2 for
// int8 rings). Two sweeps over the kv tiles, as the TPU body normalises
// whole rows before it rounds the weights: the first takes each row's max
// m and sum l = sum exp(s - m); the second recomputes the logits and adds
// round(exp(s - m) / l) kv[:, chunk], so the weights PV reads are the
// softmax rounded once, as in the TPU body (an online softmax would round
// exp(s - m_running) instead, which at narrow widths, where single rows of
// kv are large, moves the output past a bf16 step).
template <int NC, typename T, typename OutT>
__device__ void attend_rows(const T* qb, const T* kvb, OutT* ob, int row0, int ch0,
                            int P, int C, float t, unsigned char* smem) {
  using Acc = typename AccOf<T>::type;
  const Layout L = layout<T>(NC, 1);
  Acc* a_s = reinterpret_cast<Acc*>(smem + L.a);
  Acc* b_s = reinterpret_cast<Acc*>(smem + L.b);
  float* w_s = reinterpret_cast<float*>(smem + L.p);
  float* v_s = reinterpret_cast<float*>(smem + L.v);
  const int r = dot_row(), cq = dot_col();
  const T* const qa[1] = {qb};
  const T* const kva[1] = {kvb};
  Acc s[1][4];

  float m = -INFINITY, l = 0.f;  // the same in the row's 8 lanes
  for (int n0 = 0; n0 < P; n0 += kTile) {
    tile_dots<1>(s, qa, row0, kva, n0, P, C, a_s, b_s);
    float v[4], mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = n0 + cq + 8 * j < P ? to_float(s[0][j]) * t : -INFINITY;
      mx = fmaxf(mx, v[j]);
    }
    const float mn = fmaxf(m, row8_max(mx));  // finite: column n0 < P
    float e = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) e += expf(v[j] - mn);
    l = l * expf(m - mn) + row8_sum(e);     // expf(-inf) = 0 on the first tile
    m = mn;
  }
  const float inv = 1.f / l;

  float acc[8][NC / 64];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int k = 0; k < NC / 64; ++k) acc[i][k] = 0.f;
  }
  for (int n0 = 0; n0 < P; n0 += kTile) {
    tile_dots<1>(s, qa, row0, kva, n0, P, C, a_s, b_s);  // syncs: the last PV is done
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float w = n0 + cq + 8 * j < P ? expf(to_float(s[0][j]) * t - m) * inv : 0.f;
      w_s[r * kPitch + cq + 8 * j] = round_weight<T>(w);
    }
    stage_pv<NC>(v_s, kvb, n0, ch0, P, C);
    __syncthreads();
    pv_accumulate<NC>(acc, w_s, v_s);
  }
  store_rows<NC>(ob, acc, 1.f, row0, ch0, P, C);
}

}  // namespace wide
}  // namespace dcnet
