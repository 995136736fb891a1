// K6's main route on Hopper (sm_90a): the int8 convolution as an implicit
// GEMM on wgmma s8 with TMA tiles, warp-specialised, split-K through a
// thread block cluster's distributed shared memory. The library
// conv_s8_tma.cu exports it; kernels/conv_s8.py::conv_plan picks the route,
// the tiles, the stages and the split for each shape and gives the tensor
// maps' dims, strides and boxes, which the entry only encodes and launches.
// What K6 computes, and the epilogue (`finish`), are in conv_s8.cuh.
//
// Bound: 2 N Ho Wo k^2 Ci Co operations at the int8 rate (1,979 TOP/s)
// against the bytes of x, w and the output (3.35 TB/s). The backbone's 3x3
// convolutions are bound by operations, its 1x1s by bytes.
//
// Design:
// - Operands. x is int8 NHWC with Ci % 16 == 0 (a float x, or one whose
//   channels need padding to 16, is first quantized into such a copy by the
//   pass of conv_s8.cuh: `quant_pass_kernel`). The A tile of a block is
//   128 output pixels x `cbox` channels (64 or 128 bytes: the swizzle of
//   that width, so a row is one swizzle span); the B tile is `BN` rows of w
//   x the same channels. wgmma m64nBNk32 s8 x s8 -> s32 takes both K-major
//   from shared memory (8-bit wgmma takes no other layout; NHWC rows are
//   Ci-contiguous and w's rows too).
// - A's tile is one TMA box a tap. The 128 rows are a rectangle of output
//   pixels, bw x bh x bimg (powers of two, 128 together) of the output
//   (N, Ho, Wo), or 128 consecutive pixels of a 1x1 stride-1 convolution.
//   For stride s, tap (r, c) reads input row ho s + r - p = (ho + qr) s + rr
//   with rr = (r - p) mod s: the strided view x[:, rr::s, cc::s, :] is a 4-D
//   tensor map (Ci, W', H', N) of its own ("phase" maps, one for each
//   (rr, cc) the taps use: 1 at stride 1, 4 for a 3x3 at stride 2), and the
//   tap's box starts at (cb cbox, tw bw + qc, th bh + qr, tn bimg) in it.
//   TMA zero-fills coordinates outside the map: the padding, channels past
//   Ci, pixels past the image, rows of w past Co. (TMA's im2col mode was
//   the other candidate: the plan's walk of tiled boxes can be emulated and
//   tested on the CPU, byte for byte, tests/test_torch_conv_plan.py.)
// - Pipeline. 384 threads: warpgroups 0 and 1 each own 64 rows of the tile
//   and all BN columns (BN / 2 int32 accumulators a thread); warpgroup 2
//   loads (one thread starts both boxes of a stage, completion on the
//   stage's "full" mbarrier; consumers release it on its "empty" one). A
//   ring of `stages` (2-8) stages in dynamic shared memory; setmaxnreg moves
//   registers from the loading warpgroup (40) to the computing ones (232).
//   A consumer keeps one group of wgmma in flight and releases a stage when
//   the group that read it has completed.
// - Split-K. Where the grid of M x Co tiles is under a wave, `splits` (1-8)
//   blocks of a cluster share one tile, each over a contiguous range of
//   the (tap, channel block) iterations. Each leaves its int32 partial
//   tile in its shared memory (over the then idle ring); after a cluster
//   barrier block r sums rows r 128/S .. (r+1) 128/S of the S tiles in rank
//   order (int32: exact in any order) and runs the epilogue on them, 4
//   columns a thread; one split with a bf16 or int8 output takes the same
//   staged path (coalesced stores), and so does an odd Co. One split with an
//   int32 or fp32 output and an even Co runs the epilogue on each thread's
//   own accumulators and stores two columns at a time (no staging: 30-45%
//   faster on the int32 1x1s, slower for the 2- and 1-byte outputs and
//   an odd Co, PERF.md section 6).
// - Epilogue: `finish_acc` of conv_s8.cuh (the steps and roundings of
//   `finish`), the columns' scales and biases read once, the addend's row
//   once a row.
#pragma once

#include <cooperative_groups.h>

#include "attend_wgmma.cuh"
#include "conv_s8.cuh"
#include "smem.cuh"

namespace {

namespace tma {

namespace cg = cooperative_groups;
using dcnet::wg::mbar_arrive;
using dcnet::wg::mbar_expect_tx;
using dcnet::wg::mbar_init;
using dcnet::wg::mbar_wait;
using dcnet::wg::smem_u32;
using dcnet::wg::tma_load;

constexpr int kRows = 128;     // output pixels of a block (two warpgroups of 64)
constexpr int kThreads = 384;
constexpr int kMaxMaps = 16;   // phase maps of x
constexpr int kMaxTaps = 64;   // k * k
constexpr int kMaxSplits = 8;  // a portable cluster

// The geometry of one launch, as kernels/conv_s8.py::conv_plan gives it.
struct Geo {
  int wv, hv, nv;          // the output as the tiles see it: (N, Ho, Wo), or (1, 1, M)
  int bw, bh, bimg;        // the tile's rectangle, bw * bh * bimg == 128
  int tiles_w, tiles_h;    // rectangles along wv and hv (then along nv)
  int co;
  int cbox, cblocks;       // channels of a box; boxes a tap
  int kiters, splits, stages;
  int swz;                 // the wgmma descriptor's layout: 1 128B, 2 64B swizzle
  signed char tap_map[kMaxTaps];  // tap t's phase map
  short tap_dw[kMaxTaps];         // and its offsets (qc, qr) in that map
  short tap_dh[kMaxTaps];
};

struct Maps {
  CUtensorMap a[kMaxMaps];
  CUtensorMap b;
};

// d (64 x 64, s32) = (scale_d ? d : 0) + A B: A (64 x 32) and B (32 x 64) int8 in shared
// memory (descriptors), both K-major.
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 128, s32) = (scale_d ? d : 0) + A B: A (64 x 32) and B (32 x 128) int8 in shared
// memory (descriptors), both K-major.
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 256, s32) = (scale_d ? d : 0) + A B: A (64 x 32) and B (32 x 256) int8 in shared
// memory (descriptors), both K-major.
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  if constexpr (BN == 64) {
    wgmma_s8_n64(d, desc_a, desc_b, scale_d);
  } else if constexpr (BN == 128) {
    wgmma_s8_n128(d, desc_a, desc_b, scale_d);
  } else {
    wgmma_s8_n256(d, desc_a, desc_b, scale_d);
  }
}

template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// A K-major shared-memory matrix descriptor: start address, stride between
// 8-row groups (`sbo` bytes: 8 rows of one swizzle span), layout `swz`
// (1: 128B swizzle, 2: 64B).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t sbo, int swz) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)swz << 62);
}

// Four columns' epilogue constants (zero past Co or without the step).
struct Cols {
  float scale[4], bias[4], scale2[4], bias2[4];
};

__device__ __forceinline__ Cols load_cols(const Epilogue& ep, int col, int co) {
  Cols c;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool in = col + e < co && ep.scale != nullptr;
    const bool two = in && ep.scale2 != nullptr;
    c.scale[e] = in ? ep.scale[col + e] : 0.f;
    c.bias[e] = in ? ep.bias[col + e] : 0.f;
    c.scale2[e] = two ? ep.scale2[col + e] : 0.f;
    c.bias2[e] = two ? ep.bias2[col + e] : 0.f;
  }
  return c;
}

// The epilogue (`finish_acc` of conv_s8.cuh, after the addend) of four
// columns col..col+3 of output row `row` (cols past Co are not written),
// one vector store where Co % 4 == 0.
template <typename OUT>
__device__ __forceinline__ void store4(const Epilogue& ep, const Cols& cs, long long row,
                                       int col, int co, const int4& v) {
  OUT* dst = static_cast<OUT*>(ep.out) + row * co + col;
  int a[4] = {v.x, v.y, v.z, v.w};
  if (ep.addend != nullptr) {
    const int32_t* add = ep.addend + addend_row(ep, row) * co + col;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (col + e < co) a[e] += add[e];
    }
  }
  alignas(16) OUT o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    o[e] = finish_acc<OUT>(ep, a[e], cs.scale[e], cs.bias[e], cs.scale2[e], cs.bias2[e]);
  }
  if ((co & 3) == 0) {
    if constexpr (sizeof(OUT) == 4) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(o);
    } else if constexpr (sizeof(OUT) == 2) {
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(o);
    } else {
      *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(o);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (col + e < co) dst[e] = o[e];
    }
  }
}

// Rows rb..re-1 of the cluster's S partial tiles summed in rank order, the
// epilogue applied and stored; thread t (of 256) takes columns 4 (t % (BN /
// 4)) .. +3 of every (256 / (BN / 4))-th row, its columns' constants read
// once.
template <int BN, typename OUT>
__device__ __forceinline__ void reduce_store(const Geo& g, const Epilogue& ep,
                                             cg::cluster_group& cluster, int* tile, int rb,
                                             int re, int tw, int th, int tn, int n0) {
  constexpr int kPitch = BN + 4;
  constexpr int kChunks = BN / 4;
  constexpr int kRowStep = 256 / kChunks;
  const int tid = threadIdx.x;
  const int c = 4 * (tid % kChunks);
  const int col = n0 + c;
  if (col >= g.co) return;
  const Cols cs = load_cols(ep, col, g.co);
  for (int r = rb + tid / kChunks; r < re; r += kRowStep) {
    const int ow = tw * g.bw + r % g.bw;
    const int oh = th * g.bh + (r / g.bw) % g.bh;
    const int on = tn * g.bimg + r / (g.bw * g.bh);
    if (ow >= g.wv || oh >= g.hv || on >= g.nv) continue;
    int4 sum = make_int4(0, 0, 0, 0);
    for (int q = 0; q < g.splits; ++q) {
      const int4 v = *reinterpret_cast<const int4*>(
          cluster.map_shared_rank(tile, q) + r * kPitch + c);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    store4<OUT>(ep, cs, ((long long)on * g.hv + oh) * g.wv + ow, col, g.co, sum);
  }
}

// One split, a 4-byte output and an even Co: the epilogue straight from a
// thread's accumulators (rows r and r + 8 of the tile, columns 8 n8 + 2
// (lane % 4) + {0, 1}), two columns an 8-byte store (a quad of threads
// writes 32 bytes of a row); no staging, no cluster barrier.
template <int BN, typename OUT>
__device__ __forceinline__ void store_frags(const Geo& g, const Epilogue& ep,
                                            const int (&acc)[BN / 2], int r, int lane,
                                            int tw, int th, int tn, int n0) {
  long long rows[2], arows[2];
  bool ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = r + 8 * h;
    const int ow = tw * g.bw + rr % g.bw;
    const int oh = th * g.bh + (rr / g.bw) % g.bh;
    const int on = tn * g.bimg + rr / (g.bw * g.bh);
    ok[h] = ow < g.wv && oh < g.hv && on < g.nv;
    rows[h] = ((long long)on * g.hv + oh) * g.wv + ow;
    arows[h] = ep.addend != nullptr && ok[h] ? addend_row(ep, rows[h]) : 0;
  }
  OUT* out = static_cast<OUT*>(ep.out);
#pragma unroll
  for (int n8 = 0; n8 < BN / 8; ++n8) {
    const int col = n0 + n8 * 8 + (lane & 3) * 2;
    if (col >= g.co) continue;  // Co is even: col + 1 < Co too
    float sc[2] = {0.f, 0.f}, bi[2] = {0.f, 0.f}, sc2[2] = {0.f, 0.f}, bi2[2] = {0.f, 0.f};
    if (ep.scale != nullptr) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[e] = ep.scale[col + e];
        bi[e] = ep.bias[col + e];
        if (ep.scale2 != nullptr) {
          sc2[e] = ep.scale2[col + e];
          bi2[e] = ep.bias2[col + e];
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!ok[h]) continue;
      int a[2] = {acc[4 * n8 + 2 * h], acc[4 * n8 + 2 * h + 1]};
      if (ep.addend != nullptr) {
        const int32_t* add = ep.addend + arows[h] * g.co + col;
        a[0] += add[0];
        a[1] += add[1];
      }
      static_assert(sizeof(OUT) == 4, "the direct epilogue stores 4-byte outputs");
      alignas(8) OUT o[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) o[e] = finish_acc<OUT>(ep, a[e], sc[e], bi[e], sc2[e], bi2[e]);
      *reinterpret_cast<uint2*>(out + rows[h] * g.co + col) = *reinterpret_cast<const uint2*>(o);
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
conv_tma_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Geo g,
                const Epilogue ep) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int kPitch = BN + 4;  // int32 columns of a row of the staged tile
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  unsigned char* base = smem_raw + pad;
  const uint32_t base_s = raw + pad;
  const int a_bytes = kRows * g.cbox;
  const int stage_bytes = a_bytes + BN * g.cbox;
  const int ring = g.stages * stage_bytes;
  const int tile_bytes = kRows * kPitch * 4;
  const uint32_t bars = base_s + (ring > tile_bytes ? ring : tile_bytes);
  // full[s] at bars + 8 s, empty[s] at bars + 8 (stages + s)

  const int tw = blockIdx.x % g.tiles_w;
  const int th = (blockIdx.x / g.tiles_w) % g.tiles_h;
  const int tn = blockIdx.x / (g.tiles_w * g.tiles_h);
  const int n0 = blockIdx.y * BN;
  const int split = blockIdx.z;
  const int it0 = (int)((long long)g.kiters * split / g.splits);
  const int iters = (int)((long long)g.kiters * (split + 1) / g.splits) - it0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(bars + 8u * s, 1);
      mbar_init(bars + 8u * (g.stages + s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int* tile = reinterpret_cast<int*>(base);
  cg::cluster_group cluster = cg::this_cluster();
  // the epilogue staged through shared memory (and the cluster) for split-K,
  // for bf16 and int8 outputs, whose rows a thread's two columns would store
  // in 4- and 2-byte pieces, and for an odd Co, whose rows are not 8-byte
  // aligned (both slower on the card than staging)
  const bool staged =
      g.splits > 1 || ep.mode == kBf16 || ep.mode == kInt8 || (g.co & 1) != 0;
  if (tid >= 256) {
    // --- the loading warpgroup: one thread starts every copy -----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 256) {
      for (int i = 0; i < iters; ++i) {
        const int s = i % g.stages;
        const uint32_t full = bars + 8u * s;
        mbar_wait(bars + 8u * (g.stages + s), ((i / g.stages) & 1) ^ 1);
        mbar_expect_tx(full, stage_bytes);
        const int it = it0 + i;
        const int tap = it / g.cblocks;
        const int c = (it - tap * g.cblocks) * g.cbox;
        const uint32_t dst = base_s + s * stage_bytes;
        tma_load(dst, &maps.a[g.tap_map[tap]], full, c, tw * g.bw + g.tap_dw[tap],
                  th * g.bh + g.tap_dh[tap], tn * g.bimg);
        tma_load(dst + a_bytes, &maps.b, full, c, tap, n0);
      }
    }
    // the consumers' two cluster barriers of a staged epilogue (the
    // epilogue is theirs alone: code after a join of the two branches would
    // get the loaders' 40 registers)
    if (staged) {
      cluster.sync();
      cluster.sync();
    }
    return;
  }
  // --- the two computing warpgroups -------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int w = tid / 128;
  // the accumulators are written by wgmma alone (the first product of a
  // block does not read them) and not touched from the first product to the
  // last wait: one group stays in flight across iterations
  int acc[BN / 2];
  const uint32_t sbo = 8u * g.cbox;
  const int ksteps = g.cbox / 32;
  for (int i = 0; i < iters; ++i) {
    const int s = i % g.stages;
    mbar_wait(bars + 8u * s, (i / g.stages) & 1);
    const uint32_t a = base_s + s * stage_bytes + w * 64 * g.cbox;
    const uint64_t da = desc(a, sbo, g.swz);
    const uint64_t db = desc(base_s + s * stage_bytes + a_bytes, sbo, g.swz);
    dcnet::wg::wgmma_fence();
    for (int kk = 0; kk < ksteps; ++kk) {
      wgmma_s8<BN>(acc, da + 2 * kk, db + 2 * kk, i > 0 || kk > 0);  // +32 bytes along K
    }
    dcnet::wg::wgmma_commit();
    wgmma_wait_one();  // the previous stage's products have completed
    if (i > 0) mbar_arrive(bars + 8u * (g.stages + (i - 1) % g.stages));
  }
  dcnet::wg::wgmma_wait_all();
  if (iters == 0) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  }
  fence_acc(acc);
  // wgmma's accumulator layout: rows r and r + 8, columns 8 n8 + 2 (lane %
  // 4) + {0, 1}
  const int lane = tid % 32;
  const int r = w * 64 + 16 * ((tid % 128) / 32) + lane / 4;
  if (!staged) {
    if (ep.mode == kInt32) {
      store_frags<BN, int32_t>(g, ep, acc, r, lane, tw, th, tn, n0);
    } else {
      store_frags<BN, float>(g, ep, acc, r, lane, tw, th, tn, n0);
    }
    return;
  }
  // the (partial) tile into shared memory
  dcnet::wg::named_barrier(1);  // both warpgroups are done with the ring
#pragma unroll
  for (int n8 = 0; n8 < BN / 8; ++n8) {
    const int c = n8 * 8 + (lane & 3) * 2;
    *reinterpret_cast<int2*>(tile + r * kPitch + c) = make_int2(acc[4 * n8], acc[4 * n8 + 1]);
    *reinterpret_cast<int2*>(tile + (r + 8) * kPitch + c) =
        make_int2(acc[4 * n8 + 2], acc[4 * n8 + 3]);
  }
  cluster.sync();
  const int rank = (int)cluster.block_rank();  // blockIdx.z: a cluster spans z
  const int rb = rank * kRows / g.splits, re = (rank + 1) * kRows / g.splits;
  if (ep.mode == kInt32) {
    reduce_store<BN, int32_t>(g, ep, cluster, tile, rb, re, tw, th, tn, n0);
  } else if (ep.mode == kFloat) {
    reduce_store<BN, float>(g, ep, cluster, tile, rb, re, tw, th, tn, n0);
  } else if (ep.mode == kBf16) {
    reduce_store<BN, bf16>(g, ep, cluster, tile, rb, re, tw, th, tn, n0);
  } else {
    reduce_store<BN, int8_t>(g, ep, cluster, tile, rb, re, tw, th, tn, n0);
  }
  cluster.sync();  // the other blocks have read this block's tile
}

// The fields of the plan array the entry reads (kernels/conv_s8.py::
// TMA_FIELDS, in this order), then nmaps x 8 numbers of x's phase maps
// (byte offset of the view, dims[4], strides of dims 1..3 in bytes) and
// ntaps x 3 (map, dw, dh).
enum Field {
  kfNmaps, kfNtaps, kfCbox, kfBn, kfWv, kfHv, kfNv, kfBw, kfBh, kfBimg, kfTilesW,
  kfTilesH, kfTilesN, kfCo, kfCblocks, kfKiters, kfSplits, kfStages, kfSmem, kfBDim0, kfBDim1,
  kfBStride1, kfBStride2, kfFields
};

using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                            const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                            const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                            CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point (no -lcuda).
inline Encode encoder() {
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess || fn == nullptr) {
      cudaGetLastError();
      return nullptr;
    }
    encode = reinterpret_cast<Encode>(fn);
  }
  return encode;
}

// An int8 tensor map of `rank` dims (innermost first), strides of dims
// 1..rank-1 in bytes, box `box`, the swizzle of a `cbox`-byte row, zero
// fill out of bounds. Returns true when the CUDA driver accepts it.
inline bool encode(Encode fn, CUtensorMap* map, const void* base, int rank,
                   const long long* dims, const long long* strides, const int* box,
                   int cbox) {
  cuuint64_t d[4], st[3];
  cuuint32_t bx[4], elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = (cuuint64_t)dims[i];
    bx[i] = (cuuint32_t)box[i];
  }
  for (int i = 0; i < rank - 1; ++i) st[i] = (cuuint64_t)strides[i];
  const CUtensorMapSwizzle swz =
      cbox == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(base), d, st, bx,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch(const Maps& maps, const Geo& g, const Epilogue& ep, long long mtiles,
           long long ntiles, size_t smem, cudaStream_t stream) {
  auto* kernel = conv_tma_kernel<BN>;
  const int err = dcnet::prepare_smem(kernel, smem);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)mtiles, (unsigned)ntiles, (unsigned)g.splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = g.splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, maps, g, ep);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  return 0;
}

}  // namespace tma

// Error codes of the entry beside cudaError_t's (which are >= 0).
constexpr int kErrPlan = -1;   // the plan's numbers are out of range
constexpr int kErrMapA = -2;   // the CUDA driver refused one of x's tensor maps
constexpr int kErrMapB = -3;   // ... or w's
constexpr int kErrEncoder = -4;  // cuTensorMapEncodeTiled was not found

// xq (N, H, W, Ci) int8, Ci % 16 == 0, 16-byte aligned; w (Co, k, k, Ci) int8
// the same; out and the epilogue's arguments as conv_s8_entry takes them;
// `plan` the fields of tma::Field, then the phase maps and the taps.
// Returns 0, a cudaError_t code or one of the kErr codes.
int conv_s8_tma_entry(const void* xq, const void* w, void* out, const void* scale,
                      const void* bias, const void* scale2, const void* bias2,
                      const void* addend, long long addend_hw, long long addend_rep,
                      float inv_next, int mode, int act, const long long* plan,
                      void* stream) {
  using namespace tma;
  const long long* f = plan;
  const int nmaps = (int)f[kfNmaps], ntaps = (int)f[kfNtaps], cbox = (int)f[kfCbox];
  const int bn = (int)f[kfBn];
  if (nmaps < 1 || nmaps > kMaxMaps || ntaps < 1 || ntaps > kMaxTaps ||
      (cbox != 64 && cbox != 128) || (bn != 64 && bn != 128 && bn != 256) ||
      f[kfSplits] < 1 || f[kfSplits] > kMaxSplits || f[kfStages] < 2 || f[kfStages] > 8 ||
      f[kfBw] * f[kfBh] * f[kfBimg] != kRows || f[kfTilesN] < 1 || f[kfTilesN] > 0x7fffffffLL ||
      f[kfTilesW] * f[kfTilesH] * f[kfTilesN] > 0x7fffffffLL || f[kfCo] < 1 ||
      (f[kfCo] + bn - 1) / bn > 65535 || f[kfKiters] != (long long)ntaps * f[kfCblocks] ||
      mode < 0 || mode > 3 || act < 0 || act > 2 ||
      (mode == kInt32) != (scale == nullptr) || (scale != nullptr && bias == nullptr) ||
      (scale2 != nullptr && (bias2 == nullptr || scale == nullptr)) ||
      (addend != nullptr && (addend_hw < 1 || addend_rep < 1))) {
    return kErrPlan;
  }
  const Encode fn = encoder();
  if (fn == nullptr) return kErrEncoder;
  Maps maps;
  const long long* pm = plan + kfFields;
  for (int i = 0; i < nmaps; ++i, pm += 8) {
    const int box[4] = {cbox, (int)f[kfBw], (int)f[kfBh], (int)f[kfBimg]};
    if (!encode(fn, &maps.a[i], static_cast<const int8_t*>(xq) + pm[0], 4, pm + 1, pm + 5,
                box, cbox)) {
      return kErrMapA;
    }
  }
  {
    const long long dims[3] = {f[kfBDim0], f[kfBDim1], f[kfCo]};
    const long long strides[2] = {f[kfBStride1], f[kfBStride2]};
    const int box[3] = {cbox, 1, bn};
    if (!encode(fn, &maps.b, w, 3, dims, strides, box, cbox)) return kErrMapB;
  }
  Geo g;
  g.wv = (int)f[kfWv];
  g.hv = (int)f[kfHv];
  g.nv = (int)f[kfNv];
  g.bw = (int)f[kfBw];
  g.bh = (int)f[kfBh];
  g.bimg = (int)f[kfBimg];
  g.tiles_w = (int)f[kfTilesW];
  g.tiles_h = (int)f[kfTilesH];
  g.co = (int)f[kfCo];
  g.cbox = cbox;
  g.cblocks = (int)f[kfCblocks];
  g.kiters = (int)f[kfKiters];
  g.splits = (int)f[kfSplits];
  g.stages = (int)f[kfStages];
  g.swz = cbox == 128 ? 1 : 2;
  const long long* pt = plan + kfFields + 8 * nmaps;
  for (int t = 0; t < ntaps; ++t) {
    g.tap_map[t] = (signed char)pt[3 * t];
    g.tap_dw[t] = (short)pt[3 * t + 1];
    g.tap_dh[t] = (short)pt[3 * t + 2];
    if (pt[3 * t] < 0 || pt[3 * t] >= nmaps) return kErrPlan;
  }
  Epilogue ep{out, static_cast<const float*>(scale), static_cast<const float*>(bias),
              static_cast<const float*>(scale2), static_cast<const float*>(bias2),
              static_cast<const int32_t*>(addend), addend_hw, addend_rep, inv_next, mode,
              act};
  const long long mtiles = f[kfTilesW] * f[kfTilesH] * f[kfTilesN];
  const long long ntiles = (f[kfCo] + bn - 1) / bn;
  const size_t smem = (size_t)f[kfSmem];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 64) return tma::launch<64>(maps, g, ep, mtiles, ntiles, smem, s);
  if (bn == 128) return tma::launch<128>(maps, g, ep, mtiles, ntiles, smem, s);
  return tma::launch<256>(maps, g, ep, mtiles, ntiles, smem, s);
}

}  // namespace
