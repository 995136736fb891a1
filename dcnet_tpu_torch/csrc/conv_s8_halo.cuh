// K6's route for thin reductions on Hopper (sm_90a): the int8 convolution
// of conv_s8.cuh (what it computes, the quantize step, the epilogue
// `finish_acc`) where k^2 Ci is small -- Ci < 64 or k^2 Ci < 256: the
// backbone's first layer 3 -> 32, its 3x3 32 -> 64s and its 1x1 64 -> 32
// and 128 -> 64. Each of conv_s8.cu, conv_s8_bf16.cu and conv_s8_fp32.cu
// exports it for one input type, beside the gather route and the quantize
// pass of that type (they build in parallel); kernels/conv_s8.py::conv_plan
// picks the route and gives the tile, the tensor map, the shared-memory
// layout and the grid, which the entry only encodes and launches.
//
// No TPU kernel stands behind it: the JAX package's int8 convolutions are
// XLA's (dcnet_tpu/ops/quant.py::int8_conv_fn, :224-236).
//
// Bound: these shapes are bound by bytes. At 120 frames the 3x3 32 -> 64 is
// 72.5 GOP, 0.037 ms at the int8 rate, against 0.113 ms to read x and
// write the output at 3.35 TB/s; the first layer's bf16 output alone is
// 0.15 ms. So the design reads each input byte from device memory once,
// quantizes it once, and writes whole output rows.
//
// Design:
// - A tile is 128 output pixels, a rectangle th x tw of one image (tw a
//   power of two, 16 x 8 where the image is that wide), or 128 consecutive
//   pixels of a 1x1 stride-1 convolution, and all of Co. Its input is the
//   rectangle and its halo: ((th - 1) s + k) x ((tw - 1) s + k) pixels,
//   one TMA box (cp.async.bulk.tensor) placed at the tile's origin minus
//   the padding. TMA zero-fills what lies outside x: the padding comes
//   free. The map is x as (Ci, W, H, N) where a pixel is a multiple of 16
//   bytes, else each image row as one flat dimension of W Ci elements (the
//   first layer's 3 channels: 12 bytes a pixel in fp32), the box starting
//   on a 16-byte multiple (TMA's rule for the innermost coordinate; the
//   halo's first pixel `lead` elements into it).
// - The box arrives in x's own type. One pass of the block's threads
//   quantizes it (`code_byte`: the codes of `quantize` of conv_s8.cuh, on
//   full-rate instructions; each element once a tile, not once a tap) into
//   an int8 halo tile of Cp bytes a pixel (Ci padded with zeros to 4, 8 or
//   a power of two), pixels Cp + 16 bytes apart from Cp = 32 on so that the
//   eight rows of an A fragment fall in distinct banks; for Cp = 4 the
//   row pitch is 16 pixels past a multiple of 32 for the same reason.
// - The reduction runs over (tap, channel) in steps of 32 bytes on wgmma
//   m64nNk32 s8 (N = 32 or 64 columns a pass), A from registers: each
//   warp's 16 rows in mma.m16n8k32's fragment layout, read from the halo
//   tile at the tap's offset (a table of the offset of each 4-byte word of
//   the step; for Cp < 32 one step spans 32 / Cp taps, so the first
//   layer's 27 products a pixel take two steps of 36 real bytes in 64); B
//   the weights, resident: all of w (Co x k^2 Cp, at most 18 KB on the
//   paths) staged in shared memory once per block as K-major core matrices
//   (8 rows x 16 bytes) without swizzle. The next step's A fragment loads
//   while a product runs. (mma.sync m16n8k32 with B re-read by every warp,
//   the first form, spent most of a tile in its products on the card.)
// - 256 threads, two warpgroups of 64 pixels x all Co of a pass (wider Co
//   is taken 64 columns a pass over the same halo tile): no product and no
//   accumulator is padding where Co is 32 or 64.
// - Persistent blocks (three an SM at 32 columns a pass, two at 64, as
//   their registers allow without spills) walk the tiles t = blockIdx.x + i
//   gridDim.x. A ring of 1-4 raw slots, each filled by TMA behind an
//   mbarrier: as soon as a tile's box has been quantized its slot is
//   refilled with the tile `stages` ahead, so the loads of the next tiles
//   run under this tile's products and epilogue.
// - Epilogue: the steps and roundings of `finish_acc` of conv_s8.cuh,
//   without a branch an element (`finish_float`; per-element branches
//   cost more than the products on the card), into a staged tile in
//   shared memory (over the halo tile where one pass covers Co); then
//   whole pixels (all Co) copied out in 16-byte stores (NHWC: a tile row
//   of pixels is contiguous).
// The loads are TMA (UTMALDG), the form measured on the card; the first
// mma.sync kernel (the gather route of conv_s8.cuh) remains for the thin
// shapes this route cannot map (x not 16-byte aligned, rows of x that are
// not 16-byte multiples, a halo past a box or shared memory).
#pragma once

#include "attend_wgmma.cuh"
#include "conv_s8.cuh"
#include "smem.cuh"
#include "tmap.cuh"

namespace {

namespace halo {

using dcnet::wg::mbar_expect_tx;
using dcnet::wg::mbar_init;
using dcnet::wg::mbar_wait;
using dcnet::wg::smem_u32;
using dcnet::wg::tma_load;

constexpr int kRows = 128;     // output pixels of a tile
constexpr int kThreads = 256;  // eight warps of 16 rows: two warpgroups of 64 pixels,
                               // each taking all Co of a pass
constexpr int kMaxStages = 4;

// The fields of the plan array (kernels/conv_s8.py::HALO_FIELDS, in this
// order).
enum Field {
  kfKind, kfD0, kfD1, kfD2, kfD3, kfS1, kfS2, kfS3, kfB0, kfB1, kfB2, kfBoxBytes, kfCi,
  kfCp, kfK, kfStride, kfPad, kfTh, kfTw, kfHin, kfWin, kfRowElems, kfLead, kfRpitch, kfPpitch,
  kfKp, kfHv, kfWv, kfNv, kfTilesW, kfTilesH, kfTiles, kfCo, kfNchunk, kfCochunks,
  kfStages, kfGrid, kfSmem, kfRawBytes, kfOffHalo, kfOffW, kfOffConsts, kfOffTbl, kfOffOut,
  kfOutEs, kfOffBar, kfFields
};

// One launch's geometry and input, as the plan gives it.
struct Geo {
  int kind;                 // 0: map (Ci, W, H, N); 1: rows (W Ci, H, N, 1)
  int ci, cp, cp_shift;     // channels of x, of a halo pixel (a power of two)
  int k, stride, pad;
  int th, tw, tw_shift;     // the tile's rectangle of output pixels
  int hin, win;             // the halo's pixels
  int row_elems;            // elements between rows of the raw box
  int lead;                 // elements of a row box before the halo's first pixel
  int row_items;            // quantize_tile's items a halo row (16-byte chunks or words)
  unsigned long long row_magic;  // ceil(2^32 / row_items)
  int rpitch;               // pixels between rows of the int8 halo tile
  int pp;                   // bytes between pixels of the int8 halo tile
  int kp;                   // the reduction in bytes (k^2 Cp, to 32)
  int hv, wv, nv;           // the output as the tiles see it
  int tiles_w, tiles_h, tiles;
  int co, nchunk, cochunks; // Co, taken nchunk columns a pass
  int stages, box_bytes, raw_bytes;
  int off_halo, off_w, off_consts, off_tbl, off_out, off_bar;
  int qmode;                // Quant of conv_s8.cuh for a float x
  float inv;
  const float* qscale;
  const int8_t* w;
  int w_words;              // w read 4 bytes at a time (Ci % 4 == 0, aligned)
};

struct Tile {
  int tw, th, n;
};

__device__ __forceinline__ Tile tile_of(const Geo& g, int t) {
  Tile tl;
  tl.tw = t % g.tiles_w;
  const int r = t / g.tiles_w;
  tl.th = r % g.tiles_h;
  tl.n = r / g.tiles_h;
  return tl;
}

// Tile t's box into the raw slot at `dst`, completion on `bar`.
__device__ __forceinline__ void issue(const CUtensorMap* map, const Geo& g, uint32_t dst,
                                      uint32_t bar, int t) {
  const Tile tl = tile_of(g, t);
  const int wi0 = tl.tw * g.tw * g.stride - g.pad;
  const int hi0 = tl.th * g.th * g.stride - g.pad;
  mbar_expect_tx(bar, g.box_bytes);
  if (g.kind == 0) {
    tma_load(dst, map, bar, 0, wi0, hi0, tl.n);
  } else {
    tma_load(dst, map, bar, wi0 * g.ci - g.lead, hi0, tl.n, 0);
  }
}

// `quantize` of conv_s8.cuh on the full-rate pipes: the same product or
// quotient, clamped to [-127, 127] first (the same code: the bounds are
// integers) and rounded half to even by adding 1.5 2^23, whose sum's low
// byte is the code in two's complement. rintf and the float-to-int
// conversion run at a sixteenth of the rate on this card.
__device__ __forceinline__ uint32_t code_byte(float x, int qmode, float q) {
  const float y = qmode == kQuantMul ? __fmul_rn(x, q) : __fdiv_rn(x, q);
  return __float_as_uint(__fadd_rn(fminf(fmaxf(y, -127.f), 127.f), 12582912.f));
}

// The low bytes of four words as one word, b0 lowest.
__device__ __forceinline__ uint32_t pack4(uint32_t b0, uint32_t b1, uint32_t b2, uint32_t b3) {
  return __byte_perm(__byte_perm(b0, b1, 0x3340), __byte_perm(b2, b3, 0x3340), 0x5410);
}

// Four channels at src (n of them real) as four int8 codes in a word: an
// int8 x copied, a float x quantized (`code_byte`).
template <typename IN>
__device__ __forceinline__ uint32_t codes4(const IN* src, int n, bool vec, int qmode,
                                           float q) {
  uint32_t word = 0;
  if constexpr (std::is_same_v<IN, int8_t>) {
    if (vec) return *reinterpret_cast<const uint32_t*>(src);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e < n) word |= static_cast<uint32_t>(static_cast<uint8_t>(src[e])) << (8 * e);
    }
  } else {
    float v[4];
    if (vec) {  // shared memory: plain vector loads
      alignas(16) uint32_t w[kChunkWords<4, IN>];
      if constexpr (std::is_same_v<IN, float>) {
        *reinterpret_cast<uint4*>(w) = *reinterpret_cast<const uint4*>(src);
      } else {
        *reinterpret_cast<uint2*>(w) = *reinterpret_cast<const uint2*>(src);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = chunk_value<IN>(w, e);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = e < n ? to_float(src[e]) : 0.f;
    }
    uint32_t c[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] = e < n ? code_byte(v[e], qmode, q) : 0u;
    word = pack4(c[0], c[1], c[2], c[3]);
  }
  return word;
}

// One 16-byte chunk of x at src (16 / sizeof(IN) channels) as as many int8
// codes at dst: an int8 x copied, a float x quantized (`code_byte`).
template <typename IN>
__device__ __forceinline__ void codes16(const IN* src, int8_t* dst, int qmode, float q) {
  constexpr int kE = 16 / static_cast<int>(sizeof(IN));
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  if constexpr (std::is_same_v<IN, int8_t>) {
    *reinterpret_cast<uint4*>(dst) = v;
  } else {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
    uint32_t out[kE / 4];
#pragma unroll
    for (int i = 0; i < kE / 4; ++i) {
      out[i] = pack4(code_byte(chunk_value<IN>(w, 4 * i), qmode, q),
                     code_byte(chunk_value<IN>(w, 4 * i + 1), qmode, q),
                     code_byte(chunk_value<IN>(w, 4 * i + 2), qmode, q),
                     code_byte(chunk_value<IN>(w, 4 * i + 3), qmode, q));
    }
    if constexpr (kE == 4) {
      *reinterpret_cast<uint32_t*>(dst) = out[0];
    } else {
      *reinterpret_cast<uint2*>(dst) = make_uint2(out[0], out[1]);
    }
  }
}

// i / d for i, d < 2^16, with magic = ceil(2^32 / d) (exact there).
__device__ __forceinline__ int div_magic(int i, unsigned long long magic) {
  return static_cast<int>((static_cast<unsigned long long>(i) * magic) >> 32);
}

// The raw box (x's type) into the int8 halo tile, channels past Ci zero: on
// a pixel map a 16-byte chunk of x a thread at a time; on a row map a
// word (4 channels) at a time.
template <typename IN>
__device__ __forceinline__ void quantize_tile(const Geo& g, const IN* raw, int8_t* tile8,
                                              float q) {
  const int total = g.hin * g.row_items;
  if (g.kind == 0) {
    constexpr int kE = 16 / static_cast<int>(sizeof(IN));
    const int ishift = g.cp_shift - (kE == 4 ? 2 : kE == 8 ? 3 : 4);
    for (int idx = threadIdx.x; idx < total; idx += kThreads) {
      const int hr = div_magic(idx, g.row_magic);
      const int rem = idx - hr * g.row_items;
      const int hc = rem >> ishift;
      const int ch = (rem & ((1 << ishift) - 1)) * kE;
      int8_t* dst = tile8 + (hr * g.rpitch + hc) * g.pp + ch;
      if (ch < g.ci) {
        codes16<IN>(raw + hr * g.row_elems + hc * g.ci + ch, dst, g.qmode, q);
      } else if constexpr (kE == 16) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      } else if constexpr (kE == 8) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(0, 0);
      } else {
        *reinterpret_cast<uint32_t*>(dst) = 0;
      }
    }
    return;
  }
  const int wshift = g.cp_shift - 2;
  const bool vec = (g.ci & 3) == 0;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    const int hr = div_magic(idx, g.row_magic);
    const int rem = idx - hr * g.row_items;
    const int hc = rem >> wshift;
    const int ch = (rem & ((1 << wshift) - 1)) * 4;
    uint32_t word = 0;
    if (ch < g.ci) {
      word = codes4<IN>(raw + hr * g.row_elems + g.lead + hc * g.ci + ch, min(4, g.ci - ch),
                        vec, g.qmode, q);
    }
    *reinterpret_cast<uint32_t*>(tile8 + (hr * g.rpitch + hc) * g.pp + ch) = word;
  }
}

// Once a block: w into its rows (k^2 Cp bytes in (tap, channel) order, zero
// past Ci, past k^2 and past Co), the epilogue's constants, and the table
// of each reduction word's offset in the halo tile (tap offset, channel).
__device__ __forceinline__ void stage_constants(const Geo& g, const Epilogue& ep, int8_t* ws,
                                                float* consts, int* tbl) {
  const int kw = g.kp >> 2;
  const int taps = g.k * g.k;
  const int rows = g.cochunks * g.nchunk;
  for (int idx = threadIdx.x; idx < rows * kw; idx += kThreads) {
    const int co = idx / kw;
    const int kk = (idx - co * kw) * 4;
    const int tap = kk >> g.cp_shift;
    const int ch = kk & (g.cp - 1);
    uint32_t word = 0;
    if (co < g.co && tap < taps && ch < g.ci) {
      const int8_t* src = g.w + (static_cast<long long>(co) * taps + tap) * g.ci + ch;
      if (g.w_words) {
        word = *reinterpret_cast<const uint32_t*>(src);
      } else {
        for (int e = 0; e < 4 && ch + e < g.ci; ++e) {
          word |= static_cast<uint32_t>(static_cast<uint8_t>(src[e])) << (8 * e);
        }
      }
    }
    // K-major core matrices (8 rows of w x 16 bytes, 128 contiguous bytes),
    // along K first: wgmma's B without swizzle
    *reinterpret_cast<uint32_t*>(ws + ((co >> 3) * (g.kp >> 4) + (kk >> 4)) * 128 +
                                 (co & 7) * 16 + (kk & 15)) = word;
  }
  for (int c = threadIdx.x; c < rows; c += kThreads) {
    const bool in = c < g.co && ep.scale != nullptr;
    const bool two = in && ep.scale2 != nullptr;
    consts[c] = in ? ep.scale[c] : 0.f;
    consts[rows + c] = in ? ep.bias[c] : 0.f;
    consts[2 * rows + c] = two ? ep.scale2[c] : 0.f;
    consts[3 * rows + c] = two ? ep.bias2[c] : 0.f;
  }
  for (int i = threadIdx.x; i < kw; i += kThreads) {
    const int tap = (4 * i) >> g.cp_shift;
    const int ch = (4 * i) & (g.cp - 1);
    tbl[i] = tap < taps ? ((tap / g.k) * g.rpitch + tap % g.k) * g.pp + ch : 0;
  }
}

// The output row (flat NHWC pixel) of tile row r, or -1 past the output.
__device__ __forceinline__ long long out_row(const Geo& g, const Tile& tl, int r) {
  const int oh = tl.th * g.th + (r >> g.tw_shift);
  const int ow = tl.tw * g.tw + (r & (g.tw - 1));
  if (oh >= g.hv || ow >= g.wv) return -1;
  return (static_cast<long long>(tl.n) * g.hv + oh) * g.wv + ow;
}

// The float steps of `finish_acc` (conv_s8.cuh; the addend already added)
// with their roundings, selects where it branches: the same value for every
// input, and no branch an element. two: the second affine; relu / leaky:
// the activation.
__device__ __forceinline__ float finish_float(int acc, float scale, float bias, float scale2,
                                              float bias2, bool two, bool relu, bool leaky) {
  float y = __fmaf_rn(__int2float_rn(acc), scale, bias);
  y = two ? __fmaf_rn(y, scale2, bias2) : y;
  const float neg = leaky ? __fmul_rn(0.1f, y) : (relu ? 0.f : y);
  return (relu ? y > 0.f : y >= 0.f) ? y : neg;
}

// The finished values of columns c0.. of this thread's accumulators (rows
// r0 + gq and r0 + gq + 8 of the tile, columns 8 j + 2 t4 + {0, 1}: wgmma's
// layout) into the staged tile (rows 16 bytes longer than the pass's
// columns), two adjacent columns a store; scale and bias of the thread's
// columns read once a pass. `finish_float` runs on every element and a
// select keeps the output's pixels and columns; the output's rounding is
// finish_acc's (bf16 pairs in one conversion, int8 codes by `code_byte`).
// GENERAL takes the addend (a load, under its own test) and the second
// affine; without them (every thin conv of the paths) neither is looked at.
template <typename OUT, int NCH, bool GENERAL>
__device__ __forceinline__ void stage_tile(const Geo& g, const Epilogue& ep,
                                           const int (&acc)[NCH / 2], OUT* st,
                                           const float* consts, int c0,
                                           const long long (&rows)[2], int r0, int gq,
                                           int t4) {
  constexpr int kPitch = NCH + 16 / static_cast<int>(sizeof(OUT));
  constexpr int kNt = NCH / 8;
  const int n = g.cochunks * g.nchunk;
  const bool two = GENERAL && ep.scale2 != nullptr;
  const bool relu = ep.act == kRelu, leaky = ep.act == kLeaky;
  float sc[kNt][2], bi[kNt][2];
  bool in[kNt][2];
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = c0 + nt * 8 + t4 * 2 + e;
      sc[nt][e] = consts[col];
      bi[nt][e] = consts[n + col];
      in[nt][e] = col < g.co;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + gq + 8 * h;
    const long long row = rows[h];
    const bool add = GENERAL && ep.addend != nullptr;
    const long long arow = add && row >= 0 ? addend_row(ep, row) * g.co : 0;
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      const int cl = nt * 8 + t4 * 2;
      alignas(8) OUT v[2];
      float f[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        int a = acc[4 * nt + 2 * h + e];
        const bool ok = row >= 0 && in[nt][e];
        if constexpr (GENERAL) {
          if (add && ok) a += ep.addend[arow + c0 + cl + e];
        }
        const int col = c0 + cl + e;
        if constexpr (std::is_same_v<OUT, int32_t>) {
          v[e] = ok ? a : 0;
        } else {  // consts holds zeros past Co and without the second affine
          const float y = finish_float(a, sc[nt][e], bi[nt][e],
                                       GENERAL ? consts[2 * n + col] : 0.f,
                                       GENERAL ? consts[3 * n + col] : 0.f, two, relu, leaky);
          f[e] = ok ? y : 0.f;
          if constexpr (std::is_same_v<OUT, float>) v[e] = f[e];
        }
      }
      OUT* dst = st + r * kPitch + cl;
      if constexpr (std::is_same_v<OUT, bf16>) {  // both roundings to nearest even at once
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(f[0], f[1]);
      } else if constexpr (std::is_same_v<OUT, int8_t>) {  // finish_acc's requantization
        const uint32_t b0 = code_byte(f[0], kQuantMul, ep.inv_next);
        const uint32_t b1 = code_byte(f[1], kQuantMul, ep.inv_next);
        *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(__byte_perm(b0, b1, 0x3340));
      } else {
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(v);
      }
    }
  }
}

// The staged tile's columns c0.. out to the output, whole pixels: 16-byte
// stores where Co's rows are 16-byte multiples, single elements otherwise.
template <typename OUT, int NCH>
__device__ __forceinline__ void copy_out(const Geo& g, const Epilogue& ep, const OUT* st,
                                         const Tile& tl, int c0) {
  constexpr int kPitch = NCH + 16 / static_cast<int>(sizeof(OUT));
  constexpr int kPer = 16 / static_cast<int>(sizeof(OUT));
  const int ncols = min(NCH, g.co - c0);
  OUT* out = static_cast<OUT*>(ep.out);
  if (g.co % kPer == 0 && ((ncols / kPer) & (ncols / kPer - 1)) == 0) {
    const int per = ncols / kPer;  // a power of two: 16-byte vectors a row
    const int ps = __ffs(per) - 1;
    for (int idx = threadIdx.x; idx < kRows * per; idx += kThreads) {
      const int r = idx >> ps, ch = idx & (per - 1);
      const long long row = out_row(g, tl, r);
      if (row < 0) continue;
      *reinterpret_cast<uint4*>(out + row * g.co + c0 + ch * kPer) =
          *reinterpret_cast<const uint4*>(st + r * kPitch + ch * kPer);
    }
  } else if (g.co % kPer == 0) {
    const int per = ncols / kPer;
    for (int idx = threadIdx.x; idx < kRows * per; idx += kThreads) {
      const int r = idx / per, ch = idx - r * per;
      const long long row = out_row(g, tl, r);
      if (row < 0) continue;
      *reinterpret_cast<uint4*>(out + row * g.co + c0 + ch * kPer) =
          *reinterpret_cast<const uint4*>(st + r * kPitch + ch * kPer);
    }
  } else {
    for (int idx = threadIdx.x; idx < kRows * ncols; idx += kThreads) {
      const int r = idx / ncols, c = idx - r * ncols;
      const long long row = out_row(g, tl, r);
      if (row >= 0) out[row * g.co + c0 + c] = st[r * kPitch + c];
    }
  }
}

template <typename OUT, int NCH>
__device__ __forceinline__ void finish_pass(const Geo& g, const Epilogue& ep,
                                            const int (&acc)[NCH / 2], unsigned char* stage,
                                            const float* consts, const Tile& tl, int c0,
                                            const long long (&rows)[2], int r0, int gq,
                                            int t4) {
  OUT* st = reinterpret_cast<OUT*>(stage);
  if (ep.addend != nullptr || ep.scale2 != nullptr) {
    stage_tile<OUT, NCH, true>(g, ep, acc, st, consts, c0, rows, r0, gq, t4);
  } else {
    stage_tile<OUT, NCH, false>(g, ep, acc, st, consts, c0, rows, r0, gq, t4);
  }
  __syncthreads();
  copy_out<OUT, NCH>(g, ep, st, tl, c0);
  __syncthreads();  // the staged tile is free again
}

// d (64 x NCH, s32) = (scale_d ? d : 0) + A B: A (64 x 32 int8) from
// registers, each warp's 16 rows in mma.m16n8k32's fragment layout; B
// (32 x NCH int8) K-major in shared memory (descriptor).
template <int NCH>
__device__ __forceinline__ void wgmma_rs(int (&d)[NCH / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<64>(int (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(int (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// A shared-memory matrix descriptor without swizzle: start address, the
// byte offsets between core matrices (8 rows x 16 bytes, 128 contiguous
// bytes) adjacent along K (lbo) and along N (sbo).
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

template <int N>
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}



// Blocks an SM the kernel is compiled for (its registers, no spills):
// three with 32 columns a pass, two with 64 (kernels/conv_s8.py::halo_per_sm).
template <int NCH>
constexpr int kMinBlocks = NCH == 32 ? 3 : 2;

template <typename IN, int NCH>
__global__ void __launch_bounds__(kThreads, kMinBlocks<NCH>)
conv_halo_kernel(const __grid_constant__ CUtensorMap map, const __grid_constant__ Geo g,
                 const Epilogue ep) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw_s & 1023u)) & 1023u;
  unsigned char* base = smem_raw + pad;
  const uint32_t base_s = raw_s + pad;
  int8_t* halo_tile = reinterpret_cast<int8_t*>(base + g.off_halo);
  int8_t* ws = reinterpret_cast<int8_t*>(base + g.off_w);
  float* consts = reinterpret_cast<float*>(base + g.off_consts);
  int* tbl = reinterpret_cast<int*>(base + g.off_tbl);
  unsigned char* stage = base + g.off_out;
  const uint32_t bars = base_s + g.off_bar;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < g.stages; ++s) mbar_init(bars + 8u * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  stage_constants(g, ep, ws, consts, tbl);
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < g.stages; ++s) {
      const int t = blockIdx.x + s * gridDim.x;
      if (t < g.tiles) issue(&map, g, base_s + s * g.raw_bytes, bars + 8u * s, t);
    }
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16;  // the warp's 16 rows of its warpgroup's 64
  int pix[2];  // the halo tile byte of rows r0 + gq + 8 h at tap (0, 0)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + gq + 8 * h;
    pix[h] = ((r >> g.tw_shift) * g.rpitch + (r & (g.tw - 1))) * g.stride * g.pp;
  }
  const float q = g.qmode == kQuantDiv ? *g.qscale : g.inv;
  const int ksteps = g.kp >> 5;
  const uint32_t kcores = g.kp >> 4;  // core matrices of w along K
  const uint32_t ws_s = base_s + g.off_w;

  for (int i = 0, t = blockIdx.x; t < g.tiles; ++i, t += gridDim.x) {
    const int slot = i % g.stages;
    mbar_wait(bars + 8u * slot, (i / g.stages) & 1);
    quantize_tile<IN>(g, reinterpret_cast<const IN*>(base + slot * g.raw_bytes), halo_tile, q);
    __syncthreads();
    if (tid == 0) {  // the slot is read: refill it with the tile `stages` ahead
      const int next = t + g.stages * gridDim.x;
      if (next < g.tiles) issue(&map, g, base_s + slot * g.raw_bytes, bars + 8u * slot, next);
    }
    const Tile tl = tile_of(g, t);
    long long rows[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) rows[h] = out_row(g, tl, r0 + gq + 8 * h);
    for (int cc = 0; cc < g.cochunks; ++cc) {
      const int c0 = cc * g.nchunk;
      // A: this warp's 16 rows at each reduction word's tap offset; the next
      // step's fragment loads while the product runs (the accumulators are
      // written by wgmma alone from the first product to the last wait)
      const uint32_t wbase = ws_s + (uint32_t)(c0 >> 3) * kcores * 128u;
      int acc[NCH / 2];
      uint32_t a[2][4];
      auto load_a = [&](uint32_t (&frag)[4], int ks) {
        const int o0 = tbl[ks * 8 + t4], o1 = tbl[ks * 8 + 4 + t4];
        frag[0] = lds32(halo_tile + pix[0] + o0);
        frag[1] = lds32(halo_tile + pix[1] + o0);
        frag[2] = lds32(halo_tile + pix[0] + o1);
        frag[3] = lds32(halo_tile + pix[1] + o1);
      };
      load_a(a[0], 0);
      for (int ks = 0; ks < ksteps; ks += 2) {
        dcnet::wg::wgmma_fence();
        wgmma_rs<NCH>(acc, a[0], desc_kmajor(wbase + ks * 256u, 128u, kcores * 128u), ks > 0);
        dcnet::wg::wgmma_commit();
        if (ks + 1 < ksteps) load_a(a[1], ks + 1);
        wgmma_wait0();
        if (ks + 1 >= ksteps) break;
        dcnet::wg::wgmma_fence();
        wgmma_rs<NCH>(acc, a[1], desc_kmajor(wbase + (ks + 1) * 256u, 128u, kcores * 128u), 1);
        dcnet::wg::wgmma_commit();
        if (ks + 2 < ksteps) load_a(a[0], ks + 2);
        wgmma_wait0();
      }
      fence_acc(acc);
      if (g.off_out == g.off_halo) __syncthreads();  // the staged tile lies over the halo's
      if (ep.mode == kInt32) {
        finish_pass<int32_t, NCH>(g, ep, acc, stage, consts, tl, c0, rows, r0, gq, t4);
      } else if (ep.mode == kFloat) {
        finish_pass<float, NCH>(g, ep, acc, stage, consts, tl, c0, rows, r0, gq, t4);
      } else if (ep.mode == kBf16) {
        finish_pass<bf16, NCH>(g, ep, acc, stage, consts, tl, c0, rows, r0, gq, t4);
      } else {
        finish_pass<int8_t, NCH>(g, ep, acc, stage, consts, tl, c0, rows, r0, gq, t4);
      }
    }
  }
}

// Error codes of the entry beside cudaError_t's (which are >= 0).
constexpr int kErrPlan = -11;     // the plan's numbers are out of range
constexpr int kErrMap = -12;      // the CUDA driver refused x's tensor map
constexpr int kErrEncoder = -13;  // cuTensorMapEncodeTiled was not found

template <typename IN>
constexpr CUtensorMapDataType kMapType =
    std::is_same_v<IN, float> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
    : std::is_same_v<IN, bf16> ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                               : CU_TENSOR_MAP_DATA_TYPE_UINT8;

inline int log2_exact(long long v) {
  int s = 0;
  while ((1LL << s) < v) ++s;
  return (1LL << s) == v ? s : -1;
}

template <typename IN, int NCH>
int launch(const CUtensorMap& map, const Geo& g, const Epilogue& ep, int grid, size_t smem,
           cudaStream_t stream) {
  auto* kernel = conv_halo_kernel<IN, NCH>;
  const int err = dcnet::prepare_smem(kernel, smem);
  if (err != 0) return err;
  kernel<<<grid, kThreads, smem, stream>>>(map, g, ep);
  return (int)cudaGetLastError();
}

}  // namespace halo

// x (N, H, W, Ci) of the library's type as conv_s8_entry takes it (16-byte
// aligned), w (Co, k, k, Ci) int8, out and the epilogue's arguments as
// there; `plan` the fields of halo::Field. Returns 0, a cudaError_t code or
// one of halo's kErr codes.
template <typename IN>
int conv_s8_halo_entry(const void* x, int x_dtype, int qmode, float in_inv,
                       const void* in_scale, const void* w, void* out, const void* scale,
                       const void* bias, const void* scale2, const void* bias2,
                       const void* addend, long long addend_hw, long long addend_rep,
                       float inv_next, int mode, int act, const long long* plan,
                       void* stream) {
  using namespace halo;
  constexpr int kXDtype = std::is_same_v<IN, int8_t> ? 0 : (std::is_same_v<IN, float> ? 1 : 2);
  const long long* f = plan;
  const int cp_shift = log2_exact(f[kfCp]), tw_shift = log2_exact(f[kfTw]);
  const long long smem = f[kfSmem];
  if (x_dtype != kXDtype || (x_dtype == 0) != (qmode == kQuantNone) || qmode < 0 ||
      qmode > 2 || (qmode == kQuantDiv && in_scale == nullptr) || mode < 0 || mode > 3 ||
      act < 0 || act > 2 || (mode == kInt32) != (scale == nullptr) ||
      (scale != nullptr && bias == nullptr) ||
      (scale2 != nullptr && (bias2 == nullptr || scale == nullptr)) ||
      (addend != nullptr && (addend_hw < 1 || addend_rep < 1)) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0) {
    return kErrPlan;
  }
  if ((f[kfKind] != 0 && f[kfKind] != 1) || cp_shift < 2 || cp_shift > 8 ||
      (f[kfKind] == 0 && (f[kfCi] * (long long)sizeof(IN)) % 16 != 0) ||
      f[kfHin] * f[kfWin] * f[kfCp] / 4 >= (1 << 16) ||
      f[kfCi] < 1 || f[kfCi] > f[kfCp] || tw_shift < 0 || f[kfTh] * f[kfTw] != kRows ||
      f[kfK] < 1 || f[kfStride] < 1 || f[kfPad] < 0 ||
      f[kfHin] != (f[kfTh] - 1) * f[kfStride] + f[kfK] ||
      f[kfWin] != (f[kfTw] - 1) * f[kfStride] + f[kfK] || f[kfRpitch] < f[kfWin] ||
      f[kfLead] < 0 || (f[kfCi] % 4 == 0 && f[kfLead] % 4 != 0) ||
      f[kfKp] != (f[kfK] * f[kfK] * f[kfCp] + 31) / 32 * 32 ||
      (f[kfPpitch] != f[kfCp] && f[kfPpitch] != f[kfCp] + 16) ||
      (f[kfNchunk] != 32 && f[kfNchunk] != 64) || f[kfCo] < 1 ||
      f[kfCochunks] != (f[kfCo] + f[kfNchunk] - 1) / f[kfNchunk] || f[kfStages] < 1 ||
      f[kfStages] > kMaxStages || f[kfTiles] < 1 ||
      f[kfTiles] != f[kfTilesW] * f[kfTilesH] * f[kfNv] || f[kfTiles] > 0x7fffffffLL ||
      f[kfGrid] < 1 || f[kfGrid] > f[kfTiles] || smem < 1 || smem > (long long)dcnet::kSmemLimit ||
      f[kfBoxBytes] != f[kfB0] * f[kfB1] * f[kfB2] * (long long)sizeof(IN) ||
      f[kfRawBytes] < f[kfBoxBytes] || f[kfRawBytes] % 1024 != 0 ||
      f[kfOffBar] + 8 * f[kfStages] + 1024 > smem ||
      f[kfOutEs] < (mode == kBf16 ? 2 : mode == kInt8 ? 1 : 4) ||
      f[kfOffHalo] < f[kfStages] * f[kfRawBytes]) {
    return kErrPlan;
  }
  const dcnet::TensorMapEncode encode = dcnet::tensor_map_encoder();
  if (encode == nullptr) return kErrEncoder;
  CUtensorMap map;
  {
    cuuint64_t dims[4], strides[3];
    cuuint32_t box[4] = {(cuuint32_t)f[kfB0], (cuuint32_t)f[kfB1], (cuuint32_t)f[kfB2], 1};
    cuuint32_t elem[4] = {1, 1, 1, 1};
    for (int i = 0; i < 4; ++i) dims[i] = (cuuint64_t)f[kfD0 + i];
    for (int i = 0; i < 3; ++i) strides[i] = (cuuint64_t)f[kfS1 + i];
    if (encode(&map, kMapType<IN>, 4, const_cast<void*>(x), dims, strides, box, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return kErrMap;
    }
  }
  Geo g;
  g.kind = (int)f[kfKind];
  g.ci = (int)f[kfCi];
  g.cp = (int)f[kfCp];
  g.cp_shift = cp_shift;
  g.k = (int)f[kfK];
  g.stride = (int)f[kfStride];
  g.pad = (int)f[kfPad];
  g.th = (int)f[kfTh];
  g.tw = (int)f[kfTw];
  g.tw_shift = tw_shift;
  g.hin = (int)f[kfHin];
  g.win = (int)f[kfWin];
  g.row_elems = (int)f[kfRowElems];
  g.lead = (int)f[kfLead];
  {  // quantize_tile's items: 16-byte chunks of x on a pixel map, words on a row map
    const int item = g.kind == 0 ? 16 / (int)sizeof(IN) : 4;
    g.row_items = g.win * (g.cp / item);
    g.row_magic = ((1ULL << 32) + g.row_items - 1) / g.row_items;
  }
  g.rpitch = (int)f[kfRpitch];
  g.pp = (int)f[kfPpitch];
  g.kp = (int)f[kfKp];
  g.hv = (int)f[kfHv];
  g.wv = (int)f[kfWv];
  g.nv = (int)f[kfNv];
  g.tiles_w = (int)f[kfTilesW];
  g.tiles_h = (int)f[kfTilesH];
  g.tiles = (int)f[kfTiles];
  g.co = (int)f[kfCo];
  g.nchunk = (int)f[kfNchunk];
  g.cochunks = (int)f[kfCochunks];
  g.stages = (int)f[kfStages];
  g.box_bytes = (int)f[kfBoxBytes];
  g.raw_bytes = (int)f[kfRawBytes];
  g.off_halo = (int)f[kfOffHalo];
  g.off_w = (int)f[kfOffW];
  g.off_consts = (int)f[kfOffConsts];
  g.off_tbl = (int)f[kfOffTbl];
  g.off_out = (int)f[kfOffOut];
  g.off_bar = (int)f[kfOffBar];
  g.qmode = qmode;
  g.inv = in_inv;
  g.qscale = static_cast<const float*>(in_scale);
  g.w = static_cast<const int8_t*>(w);
  g.w_words = g.ci % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  Epilogue ep{out, static_cast<const float*>(scale), static_cast<const float*>(bias),
              static_cast<const float*>(scale2), static_cast<const float*>(bias2),
              static_cast<const int32_t*>(addend), addend_hw, addend_rep, inv_next, mode,
              act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (int)f[kfGrid];
  if (g.nchunk == 32) return halo::launch<IN, 32>(map, g, ep, grid, (size_t)smem, s);
  return halo::launch<IN, 64>(map, g, ep, grid, (size_t)smem, s);
}

// The library's error codes in words: the halo entry's own (negative), and
// cudaError_t's by the runtime (the other entries return only those).
inline const char* conv_s8_error_string(int code) {
  switch (code) {
    case halo::kErrPlan:
      return "the halo route's plan or arguments are out of range";
    case halo::kErrMap:
      return "the CUDA driver refused the tensor map of x (cuTensorMapEncodeTiled)";
    case halo::kErrEncoder:
      return "cuTensorMapEncodeTiled not found through cudaGetDriverEntryPoint";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // namespace
