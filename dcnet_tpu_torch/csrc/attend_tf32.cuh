// Device code of the fp32 co-attention block on the tensor cores (3xTF32),
// shared by K1/K2 (coattn.cu) and K4's fp32 rings (coattn_ring.cu): one block
// computes softmax_rows(T * q kv^T) kv for 32 rows of q against a whole
// (P, C) kv frame, fp32 in and out, C % 16 == 0 and C <= 512. As the TPU
// body computes for fp32: fp32 logits, an fp32 softmax, the unrounded fp32
// weights in PV. The design notes are in coattn.cu; in short:
//
// - 512 threads, 16 warps: 2 row groups of 16 q rows x 8 channel groups of
//   about C/8 channels (whole 8-channel tiles, tf32x3.cuh::channel_group).
//   One block fills an SM's shared memory; with 16 warps rather than 8
//   (4 channel groups) it ran 3-7% faster on the H100.
// - Shared memory holds the 32 x C q rows (loaded once) and two 32 x C kv
//   tiles, fp32 with a pitch of C + 4 floats (every fragment load of either
//   product hits 32 distinct banks), filled by cp.async: the next tile is in
//   flight while this one is used. About 226 KB at C = 512.
// - Per kv tile each warp takes the partial logits of its channels (16 x 32,
//   mma.sync m16n8k8 by 3xTF32); the eight partials of a row group are
//   summed through shared memory (32 KB, in channel-group order, so the
//   eight warps of a row group hold the same logits); each warp runs the
//   online softmax (running max and sum) on its 16 x 32 tile in registers,
//   rescales its 16 x C/8 fp32 accumulator (registers) and adds P kv[:, own
//   channels] by
//   3xTF32, P taken from the score registers (tf32x3.cuh's permuted sum
//   index). Each row is divided by its sum once, at the end.
// - Ragged P: kv rows past P are zero-filled, their logit columns are -inf,
//   q rows past P are not stored.
#pragma once

#include <math.h>

#include "tf32x3.cuh"

namespace dcnet {
namespace tf32 {

constexpr int kRows = 32;      // q rows of a block
constexpr int kTile = 32;      // kv rows of a tile
constexpr int kGroups = 8;     // channel groups
constexpr int kWarps = 2 * kGroups;  // 2 row groups of 16 rows x kGroups
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxC = 512;
constexpr int kMaxOwn = kMaxC / (8 * kGroups);  // n8 channel tiles a warp owns, at most

// The widths this block takes: fp32, C % 16 == 0, C <= 512.
__host__ __device__ inline bool takes(int C) {
  return C % 16 == 0 && C >= 16 && C <= kMaxC;
}

__host__ __device__ inline int pitch(int C) { return C + 4; }

// Dynamic shared memory of a block: q rows, two kv stages, the exchange of
// partial logits (kWarps x 4 n8 tiles x 32 lanes x float4).
__host__ __device__ inline size_t smem_bytes(int C) {
  return sizeof(float) * ((size_t)(kRows + 2 * kTile) * pitch(C) + kWarps * 4 * 32 * 4);
}

// The block's whole computation for rows row0..row0+31 of the (P, C) frame
// qb against every row of the (P, C) frame kvb (row stride C), written to the
// (P, C) frame ob.
__device__ __forceinline__ void attend_rows(const float* qb, const float* kvb,
                                            float* ob, int row0, int P, int C,
                                            float temperature,
                                            unsigned char* smem) {
  const int ld = pitch(C);
  float* q_s = reinterpret_cast<float*>(smem);
  float* kv_s = q_s + kRows * ld;  // stage s at kv_s + s * kTile * ld
  float4* xch = reinterpret_cast<float4*>(kv_s + 2 * kTile * ld);  // [warp][n8][lane]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp & 1, cg = warp >> 1;
  const Channels ch = channel_group(cg, kGroups, C);
  const int c0 = 8 * ch.first;
  const int tiles = (P + kTile - 1) / kTile;

  load_rows_async(q_s, ld, qb, row0, kRows, P, C, kThreads);
  load_rows_async(kv_s, ld, kvb, 0, kTile, P, C, kThreads);
  cp_async_commit();

  float o[kMaxOwn][4];
#pragma unroll
  for (int i = 0; i < kMaxOwn; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const float scale = temperature * kLog2e;  // logits in the log2 domain
  const float* qw = q_s + 16 * rg * ld + c0;

  for (int it = 0; it < tiles; ++it) {
    __syncthreads();  // every warp is done with tile it-1's stage and the exchange
    if (it + 1 < tiles) {
      load_rows_async(kv_s + ((it + 1) & 1) * kTile * ld, ld, kvb, (it + 1) * kTile,
                      kTile, P, C, kThreads);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile it (and q) have landed for this thread
    __syncthreads();     // ... and for every thread
    const float* kv = kv_s + (it & 1) * kTile * ld;

    // partial logits over this warp's channels: 16 rows x 32 kv rows
    float s[4][4], e[4][4];  // e: the small-part terms
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[n][j] = e[n][j] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kMaxOwn; ++i) {
      if (i < ch.count) {
        FragA a;
        load_a(a, qw + 8 * i, ld, lane);
#pragma unroll
        for (int n = 0; n < 4; n += 2) {
          FragB b0, b1;
          load_b_k2(b0, b1, kv + 8 * n * ld + c0 + 8 * i, ld, lane);
          mma3<true, true>(s[n], e[n], a, b0);
          mma3<true, true>(s[n + 1], e[n + 1], a, b1);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      xch[(warp * 4 + n) * 32 + lane] = make_float4(
          s[n][0] + e[n][0], s[n][1] + e[n][1], s[n][2] + e[n][2], s[n][3] + e[n][3]);
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float4 v = xch[(rg * 4 + n) * 32 + lane];  // channel group 0 (warp rg)
#pragma unroll
      for (int g = 1; g < kGroups; ++g) {
        const float4 u = xch[((rg + 2 * g) * 4 + n) * 32 + lane];
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      s[n][0] = v.x;
      s[n][1] = v.y;
      s[n][2] = v.z;
      s[n][3] = v.w;
    }

    // online softmax: rows g (registers 0, 1) and g + 8 (2, 3); columns
    // past P get -inf
    const int col0 = it * kTile + 2 * (lane & 3);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[n][j] = col0 + 8 * n + (j & 1) < P ? s[n][j] * scale : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));  // finite: column it*32 < P
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);  // 0 at first
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      s[n][0] = exp2f(s[n][0] - mn0);
      s[n][1] = exp2f(s[n][1] - mn0);
      s[n][2] = exp2f(s[n][2] - mn1);
      s[n][3] = exp2f(s[n][3] - mn1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    l0 = l0 * alpha0 + quad_sum(sum0);
    l1 = l1 * alpha1 + quad_sum(sum1);
#pragma unroll
    for (int i = 0; i < kMaxOwn; ++i) {
      o[i][0] *= alpha0;
      o[i][1] *= alpha0;
      o[i][2] *= alpha1;
      o[i][3] *= alpha1;
    }

    // o += P kv[:, own channels], the unrounded weights by 3xTF32
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      FragA a;
      acc_to_a(a, s[k]);
#pragma unroll
      for (int i = 0; i < kMaxOwn; ++i) {
        if (i < ch.count) {
          FragB b;
          load_b_n(b, kv + 8 * k * ld + c0 + 8 * i, ld, lane);
          mma3<true, true>(o[i], a, b);
        }
      }
    }
  }

  // each row divided by its sum once; rows past P are not stored
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r = row0 + 16 * rg + lane / 4;
  float* dst = ob + (long long)r * C + c0 + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < kMaxOwn; ++i) {
    if (i < ch.count) {
      if (r < P) {
        *reinterpret_cast<float2*>(dst + 8 * i) = make_float2(o[i][0] * inv0, o[i][1] * inv0);
      }
      if (r + 8 < P) {
        *reinterpret_cast<float2*>(dst + 8 * C + 8 * i) =
            make_float2(o[i][2] * inv1, o[i][3] * inv1);
      }
    }
  }
}

}  // namespace tf32
}  // namespace dcnet
