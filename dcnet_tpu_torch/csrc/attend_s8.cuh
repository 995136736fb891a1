// Device code of K4's int8-ring block on Hopper's tensor-core path
// (coattn_ring.cu): one block computes, for 64 center rows of an int8 ring
// against a whole int8 reference frame, C % 128 == 0 and C <= 512 (every
// configuration the repository runs), what the TPU body computes
// (dcnet_tpu/ops/pallas/coattn.py, _ring_attend_kernel):
//
//     logits = float32(int32(q8 kv8^T)) * T/127^2   (exact int32 sums)
//     w      = bf16(softmax_rows(logits))
//     out    = bf16(w bf16(bf16(kv8) * bf16(1/127)))   (fp32 sums)
//
// It follows the bf16 block (attend_wgmma.cuh; notes in coattn.cu):
//
// - 384 threads: warpgroups 0 and 1 compute, warpgroup 2 loads (one thread
//   issues every TMA copy); setmaxnreg gives the computing warpgroups 240
//   registers a thread.
// - TMA reads int8 tiles off the ring in place through one 4-D tensor map
//   (C, P, S, B) of 8-bit elements: boxes of 64 rows x 128 channels (128
//   bytes, 128B swizzle), the 64 x C q tile once, kv tiles into two
//   mbarrier stages.
// - QK^T on wgmma m64n64k32 s8 x s8 -> s32, both operands K-major (8-bit
//   wgmma takes no other layout; the ring's rows are C-contiguous, so q and
//   kv tiles already are). Warpgroup w sums its half of the channels; the
//   two int32 partials are added through 2 x 16 KB of shared memory, which
//   is exact in any order, then converted by __int2float_rn (XLA's astype).
// - PV on bf16 wgmma m64n(C/2)k16, the weights as the A operand from
//   registers, B the MN-major dequantised tile: each computing warpgroup
//   writes bf16(bf16(v) * bf16(1/127)) of its own channels of the int8 tile
//   into one bf16 copy in shared memory, in the 128B-swizzled layout of the
//   bf16 block's TMA tiles, while its QK^T products run (int8 -> fp32 by a
//   byte permute and one subtraction, exact; the scale by one packed bf16
//   multiply a pair). The copy is rounded as the TPU body rounds it, so the
//   scale cannot move to the output. The int8 stage is released as soon as
//   the products that read it and the copy are done, before the softmax.
//   Two other places for the copy ran slower on the H100: the loading
//   warpgroup writing it into a second buffer (12%: its 128 threads could
//   not keep up) and half of it written during the PV products (3%).
// - Shared memory at C = 512: q 32 KB, two int8 stages 64 KB, the bf16 copy
//   64 KB, the exchange 32 KB: 194 KB, one block per SM.
// - Ragged P: TMA zero-fills rows past P, logit columns past P are -inf,
//   rows past P are not stored.
#pragma once

#include "attend_wgmma.cuh"

namespace dcnet {
namespace s8 {

using bf16 = __nv_bfloat16;
using wg::Frame;

constexpr int kRows = 64;                    // q rows of a block, kv rows of a tile
constexpr int kBox = 128;                    // int8 channels of one TMA box: 128 bytes
constexpr int kBoxBytes = kRows * kBox;      // 8 KB, 1024-byte aligned in smem
constexpr int kBoxBytes16 = wg::kBoxBytes;   // a bf16 box of the copy: 64 channels
constexpr int kThreads = 384;
constexpr int kStages = 2;
constexpr int kXchInts = 64 * 64;            // one warpgroup's partial scores

// The shapes this block takes: int8 rings with C a multiple of 128 up to 512.
__host__ __device__ inline bool takes(int C) {
  return C % 128 == 0 && C >= 128 && C <= 512;
}

// Dynamic shared memory: q and the int8 stages (C bytes a row), the bf16
// copy (2 C a row), the exchange, five mbarriers, 1 KB of alignment.
__host__ __device__ inline size_t smem_bytes(int C) {
  return (size_t)C * kRows * (1 + kStages) + (size_t)C * kRows * 2 +
         2 * kXchInts * 4 + 64 + 1024;
}

// d (64 x 64, s32) = (scale_d ? d : 0) + A B, A (64 x 32) and B (32 x 64)
// int8 in shared memory, both K-major.
__device__ __forceinline__ void wgmma_s8_m64n64(int (&d)[32], uint64_t desc_a,
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void fence_regs(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// Four int8 values (one 32-bit word) as exact floats: each byte, offset by
// 128, becomes the low byte of 2^23 + byte, then 2^23 + 128 is subtracted.
__device__ __forceinline__ void int8x4_to_float(uint32_t word, float (&f)[4]) {
  const uint32_t x = word ^ 0x80808080u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[k] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440u + k)) - 8388736.0f;
  }
}

// bf16(bf16(a) * s2), bf16(bf16(b) * s2) for integers |a|, |b| <= 127 (exact
// in bf16): one packed bf16 multiply, which rounds the exact product once,
// as the TPU body's bf16 product does.
__device__ __forceinline__ uint32_t dequant_pair(float a, float b, __nv_bfloat162 s2) {
  __nv_bfloat162 v = __hmul2(__floats2bfloat162_rn(a, b), s2);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Warpgroup w's channels [w C/2, (w+1) C/2) of the int8 tile at kv8 (TMA
// layout: 128-channel boxes, 128B swizzle) dequantised into the bf16 copy
// at deq (64-channel boxes, the same swizzle), thread t of 128. Each 16
// int8 channels become two 16-byte chunks of a bf16 row; threads whose
// chunks fall in an odd bf16 box store them in the other order, so the 8
// stores of a quarter warp hit 8 distinct bank groups.
template <int C>
__device__ __forceinline__ void dequantise(const unsigned char* kv8, unsigned char* deq,
                                           int w, int t) {
  constexpr int NW = C / 2;
  constexpr int kChunksRow = NW / 16;  // 16-byte int8 chunks of a row's own channels
  const __nv_bfloat162 s2 = __float2bfloat162_rn(1.0f / 127.0f);
#pragma unroll 2
  for (int i = t; i < kRows * kChunksRow; i += 128) {
    const int r = i / kChunksRow;
    const int c0 = w * NW + 16 * (i % kChunksRow);
    const int sw = r & 7;
    const uint4 v = *reinterpret_cast<const uint4*>(
        kv8 + (c0 / kBox) * kBoxBytes + r * 128 + ((((c0 % kBox) / 16) ^ sw) << 4));
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
    uint32_t h[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float f[4];
      int8x4_to_float(words[q], f);
      h[2 * q] = dequant_pair(f[0], f[1], s2);
      h[2 * q + 1] = dequant_pair(f[2], f[3], s2);
    }
    unsigned char* row = deq + (c0 / 64) * kBoxBytes16 + r * 128;
    const int j = (c0 % 64) / 8;  // even: the first of two 8-channel chunks
    const int odd = (c0 / 64) & 1;
    const uint4 lo = make_uint4(h[0], h[1], h[2], h[3]);
    const uint4 hi = make_uint4(h[4], h[5], h[6], h[7]);
    *reinterpret_cast<uint4*>(row + (((j + odd) ^ sw) << 4)) = odd ? hi : lo;
    *reinterpret_cast<uint4*>(row + (((j + 1 - odd) ^ sw) << 4)) = odd ? lo : hi;
  }
}

// The block's whole computation for center rows row0..row0+63 (frame fq of
// the ring's map) against every row of the reference frame fkv, written to
// the (P, C) bf16 frame `ob`. `t` is T/127^2. Accumulator and A-fragment
// layouts as in wg::attend_rows (the s32 accumulator of m64n64k32 has the
// f32 one's layout).
template <int C>
__device__ __forceinline__ void attend_rows(const CUtensorMap* map, Frame fq, Frame fkv,
                                            bf16* ob, int row0, int P, float t,
                                            unsigned char* smem_raw) {
  static_assert(C % 128 == 0 && C <= 512, "the int8 block takes C % 128 == 0, C <= 512");
  constexpr uint32_t kTileBytes = C * kRows;  // one int8 tile
  constexpr int kBoxes = C / kBox;
  constexpr int NW = C / 2;                   // channels of one computing warpgroup
  constexpr int kSteps = NW / 32;             // its k32 steps of QK^T

  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  unsigned char* base = smem_raw + pad;
  const uint32_t q_s = raw + pad;
  const uint32_t kv_s = q_s + kTileBytes;     // stage s at kv_s + s * kTileBytes
  const uint32_t deq_off = (1 + kStages) * kTileBytes;
  int* xch = reinterpret_cast<int*>(base + deq_off + 2 * kTileBytes);
  const uint32_t bars = wg::smem_u32(xch + 2 * kXchInts);
  const uint32_t q_full = bars;               // then full[kStages], empty[kStages]

  const int tid = threadIdx.x;
  if (tid == 0) {
    wg::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(bars + 8u * (1 + s), 1);
      wg::mbar_init(bars + 8u * (1 + kStages + s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int tiles = (P + kRows - 1) / kRows;

  if (tid >= 256) {
    // --- the loading warpgroup: one thread issues every copy ---------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 256) {
      wg::mbar_expect_tx(q_full, kTileBytes);
      for (int j = 0; j < kBoxes; ++j) {
        wg::load_box<4>(q_s + j * kBoxBytes, map, q_full, j * kBox, row0, fq);
      }
      for (int it = 0; it < tiles; ++it) {
        const int s = it % kStages;
        const uint32_t full = bars + 8u * (1 + s);
        wg::mbar_wait(bars + 8u * (1 + kStages + s), ((it / kStages) & 1) ^ 1);
        wg::mbar_expect_tx(full, kTileBytes);
        const uint32_t dst = kv_s + s * kTileBytes;
        for (int j = 0; j < kBoxes; ++j) {
          wg::load_box<4>(dst + j * kBoxBytes, map, full, j * kBox, it * kRows, fkv);
        }
      }
    }
  } else {
    // --- the two computing warpgroups ---------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int w = tid / 128, t_ = tid % 128, lane = t_ % 32;
    float o[NW / 2];
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    const float scale = t * wg::kLog2e;  // logits in the log2 domain
    int4* x_mine = reinterpret_cast<int4*>(xch + w * kXchInts);
    const int4* x_other = reinterpret_cast<const int4*>(xch + (1 - w) * kXchInts);
    const uint64_t dq = wg::make_desc(q_s, 16, 1024);
    // MN-major B of PV: own 64-channel boxes of the copy, kBoxBytes16 apart
    const uint64_t dv = wg::make_desc(raw + pad + deq_off + w * (NW / 64) * kBoxBytes16,
                                      kBoxBytes16, 1024);
    wg::mbar_wait(q_full, 0);

    for (int it = 0; it < tiles; ++it) {
      const int s = it % kStages;
      const uint32_t kv = kv_s + s * kTileBytes;
      const uint64_t dk = wg::make_desc(kv, 16, 1024);
      wg::mbar_wait(bars + 8u * (1 + s), (it / kStages) & 1);

      // partial int32 logits over own channels: k-steps of 32 channels (32
      // bytes inside a 128-byte swizzled row, then the next box)
      int sc[32];
      wg::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        const int kk = w * kSteps + ks;
        const uint32_t off = ((kk / 4) * kBoxBytes + (kk % 4) * 32) >> 4;
        wgmma_s8_m64n64(sc, dq + off, dk + off, ks > 0);
      }
      wg::wgmma_commit();
      // the bf16 copy of own channels while the products run (the last
      // tile's PV products, its only reader, have completed)
      dequantise<C>(base + (kv - q_s), base + deq_off, w, t_);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg::wgmma_wait_all();
      fence_regs(sc);
      wg::mbar_arrive(bars + 8u * (1 + kStages + s));  // this stage may be refilled

      // the two warpgroups' partials: an int32 sum is exact in either order;
      // barrier 2 also orders every thread's copy before the PV products
      wg::named_barrier(1);  // the other warpgroup has read my last partial
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        x_mine[i * 128 + t_] = make_int4(sc[4 * i], sc[4 * i + 1], sc[4 * i + 2],
                                         sc[4 * i + 3]);
      }
      wg::named_barrier(2);
      float sf[32];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int4 v = x_other[i * 128 + t_];
        sf[4 * i] = __int2float_rn(sc[4 * i] + v.x);
        sf[4 * i + 1] = __int2float_rn(sc[4 * i + 1] + v.y);
        sf[4 * i + 2] = __int2float_rn(sc[4 * i + 2] + v.z);
        sf[4 * i + 3] = __int2float_rn(sc[4 * i + 3] + v.w);
      }

      // online softmax; rows r (registers 4 n8 + {0, 1}) and r + 8
      // (4 n8 + {2, 3}); columns past P get -inf
      const int col0 = it * kRows + (lane & 3) * 2;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float v = sf[4 * n8 + j] * scale;
          sf[4 * n8 + j] = col0 + n8 * 8 + (j & 1) < P ? v : -INFINITY;
        }
        mx0 = fmaxf(mx0, fmaxf(sf[4 * n8], sf[4 * n8 + 1]));
        mx1 = fmaxf(mx1, fmaxf(sf[4 * n8 + 2], sf[4 * n8 + 3]));
      }
      const float mn0 = fmaxf(m0, wg::quad_max(mx0));  // finite: column it*64 < P
      const float mn1 = fmaxf(m1, wg::quad_max(mx1));
      const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);  // 0 at first
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8) {
        sf[4 * n8] = exp2f(sf[4 * n8] - mn0);
        sf[4 * n8 + 1] = exp2f(sf[4 * n8 + 1] - mn0);
        sf[4 * n8 + 2] = exp2f(sf[4 * n8 + 2] - mn1);
        sf[4 * n8 + 3] = exp2f(sf[4 * n8 + 3] - mn1);
        sum0 += sf[4 * n8] + sf[4 * n8 + 1];
        sum1 += sf[4 * n8 + 2] + sf[4 * n8 + 3];
      }
      l0 = l0 * alpha0 + wg::quad_sum(sum0);
      l1 = l1 * alpha1 + wg::quad_sum(sum1);
#pragma unroll
      for (int n8 = 0; n8 < NW / 8; ++n8) {
        o[4 * n8] *= alpha0;
        o[4 * n8 + 1] *= alpha0;
        o[4 * n8 + 2] *= alpha1;
        o[4 * n8 + 3] *= alpha1;
      }
      uint32_t pa[4][4];  // the weights rounded to bf16, as A fragments
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[k][i] = wg::pack_bf16(sf[8 * k + 2 * i], sf[8 * k + 2 * i + 1]);
        }
      }

      // o += P deq[:, own channels]: k-steps of 16 kv rows (2048 bytes)
      wg::fence_regs(o);
      wg::wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wg::wgmma_pv<NW>(o, pa[k], dv + ((k * 16 * 128) >> 4));
      }
      wg::wgmma_commit();
      wg::wgmma_wait_all();
      wg::fence_regs(o);
    }

    // each row divided by its sum once; rows past P are not stored
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const int r = row0 + 16 * (t_ / 32) + lane / 4;
    bf16* dst = ob + (long long)r * C + w * NW + (lane & 3) * 2;
#pragma unroll
    for (int n8 = 0; n8 < NW / 8; ++n8) {
      if (r < P) {
        *reinterpret_cast<uint32_t*>(dst + n8 * 8) =
            wg::pack_bf16(o[4 * n8] * inv0, o[4 * n8 + 1] * inv0);
      }
      if (r + 8 < P) {
        *reinterpret_cast<uint32_t*>(dst + 8 * C + n8 * 8) =
            wg::pack_bf16(o[4 * n8 + 2] * inv1, o[4 * n8 + 3] * inv1);
      }
    }
  }
}

}  // namespace s8
}  // namespace dcnet
