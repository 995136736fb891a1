// K4: multi-reference co-attention straight off a feature ring, for Hopper
// (sm_90a).
//
// Replaces dcnet_tpu/ops/pallas/coattn.py::coattention_ring (kernel body
// _ring_attend_kernel), dispatched by coattention_ring_fused and reached from
// DCNet.corr_features when cfg.coattn_multiref is set (the serving engine's
// correspondence stage). For a (B, S, P, C) ring whose newest frame sits in
// physical slot `slot`, temporal frame j lives in slot (slot + 1 + j) mod S.
// With the center at temporal index center_t and the references ref_t(r) =
// r + (r >= center_t), r = 0..S-2:
//
//     out[b, r] = softmax_rows(T * cen ref_r^T) ref_r,
//     cen = ring[b, (slot+1+center_t) mod S], ref_r = ring[b, (slot+1+ref_t(r)) mod S]
//
// out: (B, S-1, P, C), references in temporal order. One launch covers every
// reference of every batch row: both operands are read from the ring in place
// (nothing is gathered or stacked in device memory). The slot is passed by
// value: the serving engine carries it as a host integer, so a tick reads no
// device scalar and syncs nothing.
//
// Precision follows the TPU kernel. Float rings are K1's blocks: fp32
// logits and softmax, bf16 rings on the tensor cores with the softmax
// weights rounded to bf16 before PV, fp32 rings on the tensor cores by
// 3xTF32 with the unrounded weights. int8 rings (features quantised as
// clip(round(127 f)), f l2-normalised) take the logits as exact int32 sums,
// converted to fp32 by __int2float_rn (XLA's astype) and scaled by
// T/127^2; the PV product reads kv dequantised as bf16(bf16(kv) *
// bf16(1/127)), the rounding the TPU body gives it, with bf16 weights and
// fp32 accumulation. The output is bf16 for int8 rings and the ring's dtype
// otherwise.
//
// Bound per launch: 4*B*(S-1)*P^2*C operations and B*S*P*C input elements
// read once plus B*(S-1)*P*C output elements written once. On the serving
// tick (B = 120 streams, S = 5, C = 512) the P = 1024 launch is compute-bound:
// 1.03e12 operations, about 1.04 ms at the H100's 989 TFLOP/s bf16 data-sheet
// rate (int8: half of them at 1979 TOP/s; fp32: 6.25 ms at 3xTF32's
// 495 / 3 TFLOP/s), against 1.13 GB of traffic in bf16 ((5 + 4) * P * C * 2
// bytes a stream; 0.34 ms at 3.35 TB/s). The P = 64 launch is memory-bound.
//
// Design. The TPU grid (B, refs, row tiles) keeps each reference's (P, C)
// block resident in VMEM across the center's row tiles. Here the grid is one
// dimension of B*(S-1)*ceil(P/rows) blocks (y and z are capped at 65535),
// ordered so that the blocks of one (b, reference) pair run next to each
// other and share the reference in L2; each block picks its center and
// reference slots by (slot + 1 + t) mod S. The blocks are K1's, chosen by
// dtype and C in the entry point by K1's rule (blocks.cuh), never as a
// fallback; every C >= 1 has one:
//
// - bf16 rings with C % 128 == 0 and C <= 512: K1's wgmma + TMA block
//   (attend_wgmma.cuh, the design notes in coattn.cu), 64 center rows a
//   block (7,680 blocks at 120 streams and P = 1024), over one 4-D tensor
//   map (C, P, S, B) of the ring in place: TMA reads the center's rows and
//   the reference's tiles by their (slot, stream) coordinates.
// - int8 rings with C % 128 == 0 and C <= 512: the int8 block of
//   attend_s8.cuh, built as the bf16 one: TMA boxes of 128 int8 channels
//   off a 4-D map of 8-bit elements, QK^T on wgmma s8 x s8 -> s32, PV on
//   bf16 wgmma against a dequantised bf16 copy of the tile that the
//   computing warpgroups write while their QK^T products run. It replaces
//   a block of 32 rows on WMMA with synchronous loads and the int32 scores
//   and fp32 accumulator in shared memory (on the H100 18.7 ms at 120
//   streams, P = 1024, against a 0.78 ms bound; this block 3.1 ms).
// - fp32 rings with C % 16 == 0 and C <= 512: K1's 3xTF32 block
//   (attend_tf32.cuh), 32 center rows a block.
// - bf16 rings of other widths with C % 16 == 0, C <= 672: K1's WMMA block
//   of attend_tile.cuh, 32 center rows a block.
// - every other width, in each ring dtype: the general block of
//   attend_wide.cuh, 32 center rows and one output chunk of at most 512
//   channels a block.
#include <type_traits>

#include "blocks.cuh"

namespace {

using namespace dcnet;

static_assert(tf32::kRows == kBlockM, "ring_kernel's grid serves the fp32 and WMMA blocks");

// Threads of ring_kernel's block for ring dtype T.
template <typename T>
constexpr int kRingThreads = std::is_same<T, float>::value ? tf32::kThreads : kThreads;

// Center and reference frames of block `pair` = b * (S - 1) + r.
template <typename T>
struct Frames {
  const T* q;
  const T* kv;
  long long b;
  int r;
};

template <typename T>
__device__ __forceinline__ Frames<T> frames(const T* ring, int pair, int S, int center_t,
                                            int slot, long long b_stride,
                                            long long s_stride) {
  const int n_ref = S - 1;
  const int r = pair % n_ref;
  const long long b = pair / n_ref;
  const int ref_t = r < center_t ? r : r + 1;
  const T* f = ring + b * b_stride;
  return {f + (long long)((slot + 1 + center_t) % S) * s_stride,
          f + (long long)((slot + 1 + ref_t) % S) * s_stride, b, r};
}

// The fp32 3xTF32 block and the bf16 WMMA block.
template <typename T>
__global__ void __launch_bounds__(kRingThreads<T>, 1)
ring_kernel(const T* ring, T* out, int S, int center_t, int slot, int tiles,
            int P, int C, long long b_stride, long long s_stride, float t) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tile = blockIdx.x % tiles;
  const Frames<T> f = frames(ring, blockIdx.x / tiles, S, center_t, slot, b_stride,
                             s_stride);
  T* ob = out + (f.b * (S - 1) + f.r) * (long long)P * C;
  if constexpr (std::is_same<T, float>::value) {
    tf32::attend_rows(f.q, f.kv, ob, tile * kBlockM, P, C, t, smem);
  } else {
    attend_rows<T, T>(f.q, f.kv, ob, tile * kBlockM, P, C, t, smem);
  }
}

// The general block: blockIdx.x = ((pair * nch) + chunk) * tiles + tile.
template <typename T, typename OutT, int NC>
__global__ void __launch_bounds__(wide::kThreads, 1)
ring_wide_kernel(const T* ring, OutT* out, int S, int center_t, int slot, int tiles,
                 int nch, int P, int C, long long b_stride, long long s_stride,
                 float t) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tile = blockIdx.x % tiles;
  const int rest = blockIdx.x / tiles;
  const Frames<T> f = frames(ring, rest / nch, S, center_t, slot, b_stride, s_stride);
  OutT* ob = out + (f.b * (S - 1) + f.r) * (long long)P * C;
  wide::attend_rows<NC, T, OutT>(f.q, f.kv, ob, tile * wide::kRows,
                                 (rest % nch) * NC, P, C, t, smem);
}

// The bf16 wgmma + TMA block over a ring: one 4-D map (C, P, S, B); each
// block picks its center and reference slots as ring_kernel does.
template <int C>
__global__ void __launch_bounds__(wg::kThreads, 1)
ring_wgmma_kernel(const __grid_constant__ CUtensorMap map, bf16* out, int S,
                  int center_t, int slot, int tiles, int P, float t) {
  extern __shared__ __align__(128) unsigned char smem[];  // aligned to 1024 inside
  const int n_ref = S - 1;
  const int tile = blockIdx.x % tiles;
  const int rest = blockIdx.x / tiles;
  const int r = rest % n_ref;
  const int b = rest / n_ref;
  const int ref_t = r < center_t ? r : r + 1;
  wg::attend_rows<C, 4>(&map, {(slot + 1 + center_t) % S, b}, &map,
                        {(slot + 1 + ref_t) % S, b},
                        out + ((long long)b * n_ref + r) * P * C, tile * wg::kRows,
                        P, t, smem);
}

// The int8 wgmma s8 + TMA block over an int8 ring: one 4-D map (C, P, S, B)
// of 8-bit elements; slots as above; bf16 out.
template <int C>
__global__ void __launch_bounds__(s8::kThreads, 1)
ring_s8_kernel(const __grid_constant__ CUtensorMap map, bf16* out, int S,
               int center_t, int slot, int tiles, int P, float t) {
  extern __shared__ __align__(128) unsigned char smem[];  // aligned to 1024 inside
  const int n_ref = S - 1;
  const int tile = blockIdx.x % tiles;
  const int rest = blockIdx.x / tiles;
  const int r = rest % n_ref;
  const int b = rest / n_ref;
  const int ref_t = r < center_t ? r : r + 1;
  s8::attend_rows<C>(&map, {(slot + 1 + center_t) % S, b}, {(slot + 1 + ref_t) % S, b},
                     out + ((long long)b * n_ref + r) * P * C, tile * s8::kRows, P, t,
                     smem);
}

// Blocks of a grid of B * (S - 1) * per_pair, as one dimension.
inline int grid_1d(int B, int S, long long per_pair, unsigned* blocks) {
  const long long n = (long long)B * (S - 1) * per_pair;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  *blocks = (unsigned)n;
  return 0;
}

template <int C, bool kInt8>
int launch_tma(const void* ring, void* out, int B, int S, int P, int center_t,
               int slot, long long b_stride, long long s_stride, float t,
               cudaStream_t stream) {
  constexpr long long kSize = kInt8 ? 1 : 2;
  CUtensorMap map;
  const uint64_t dims[4] = {(uint64_t)C, (uint64_t)P, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)(C * kSize), (uint64_t)(s_stride * kSize),
                               (uint64_t)(b_stride * kSize)};
  const int enc = kInt8 ? wg::encode_map(&map, ring, 4, dims, strides,
                                         CU_TENSOR_MAP_DATA_TYPE_UINT8, s8::kBox)
                        : wg::encode_map(&map, ring, 4, dims, strides);
  if (enc != 0) return enc;
  const size_t bytes = kInt8 ? s8::smem_bytes(C) : wg::smem_bytes(C);
  auto kernel = kInt8 ? ring_s8_kernel<C> : ring_wgmma_kernel<C>;
  int err = prepare_smem(kernel, bytes);
  if (err != 0) return err;
  const int tiles = (P + wg::kRows - 1) / wg::kRows;
  unsigned blocks;
  err = grid_1d(B, S, tiles, &blocks);
  if (err != 0) return err;
  kernel<<<blocks, wg::kThreads, bytes, stream>>>(map, static_cast<bf16*>(out), S,
                                                   center_t, slot, tiles, P, t);
  return (int)cudaGetLastError();
}

template <bool kInt8>
int launch_tma_c(const void* ring, void* out, int B, int S, int P, int C,
                 int center_t, int slot, long long b_stride, long long s_stride,
                 float t, cudaStream_t s) {
  switch (C) {
    case 128: return launch_tma<128, kInt8>(ring, out, B, S, P, center_t, slot, b_stride, s_stride, t, s);
    case 256: return launch_tma<256, kInt8>(ring, out, B, S, P, center_t, slot, b_stride, s_stride, t, s);
    case 384: return launch_tma<384, kInt8>(ring, out, B, S, P, center_t, slot, b_stride, s_stride, t, s);
    case 512: return launch_tma<512, kInt8>(ring, out, B, S, P, center_t, slot, b_stride, s_stride, t, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const void* ring, void* out, int B, int S, int P, int C, int center_t,
           int slot, long long b_stride, long long s_stride, float t,
           cudaStream_t stream) {
  size_t bytes;
  if constexpr (std::is_same<T, float>::value) {
    bytes = tf32::smem_bytes(C);
  } else {
    bytes = layout<T>(C).total;
  }
  int err = prepare_smem(ring_kernel<T>, bytes);
  if (err != 0) return err;
  const int tiles = (P + kBlockM - 1) / kBlockM;
  unsigned blocks;
  err = grid_1d(B, S, tiles, &blocks);
  if (err != 0) return err;
  ring_kernel<T><<<blocks, kRingThreads<T>, bytes, stream>>>(
      static_cast<const T*>(ring), static_cast<T*>(out), S, center_t, slot, tiles,
      P, C, b_stride, s_stride, t);
  return (int)cudaGetLastError();
}

template <typename T, typename OutT, int NC>
int launch_wide_nc(const void* ring, void* out, int B, int S, int P, int C,
                   int center_t, int slot, long long b_stride, long long s_stride,
                   float t, cudaStream_t stream) {
  const size_t bytes = wide::layout<T>(NC, 1).total;
  int err = prepare_smem(ring_wide_kernel<T, OutT, NC>, bytes);
  if (err != 0) return err;
  const int tiles = (P + wide::kRows - 1) / wide::kRows;
  const int nch = wide::chunks(C);
  unsigned blocks;
  err = grid_1d(B, S, (long long)tiles * nch, &blocks);
  if (err != 0) return err;
  ring_wide_kernel<T, OutT, NC><<<blocks, wide::kThreads, bytes, stream>>>(
      static_cast<const T*>(ring), static_cast<OutT*>(out), S, center_t, slot, tiles,
      nch, P, C, b_stride, s_stride, t);
  return (int)cudaGetLastError();
}

template <typename T, typename OutT>
int launch_wide(const void* ring, void* out, int B, int S, int P, int C,
                int center_t, int slot, long long b_stride, long long s_stride,
                float t, cudaStream_t s) {
  return wide::with_chunk(C, [&](auto nc) {
    return launch_wide_nc<T, OutT, decltype(nc)::value>(ring, out, B, S, P, C, center_t,
                                                        slot, b_stride, s_stride, t, s);
  });
}

}  // namespace

extern "C" {

// ring: (B, S, P, C) with rows of C contiguous, batch and slot strides in
// elements; out: (B, S-1, P, C) contiguous, in the ring's dtype (bfloat16 for
// int8 rings). dtype: 0 = float32, 1 = bfloat16, 2 = int8; the block by
// K1's rule (blocks.cuh, dcnet_coattn_block). slot is the physical slot of
// the newest frame, 0 <= slot < S. t is the softmax temperature for float
// rings and T/127^2 for int8 rings. Returns a cudaError_t code, 0 on
// success.
int dcnet_coattn_ring(const void* ring, void* out, int B, int S, int P, int C,
                      int center_t, int slot, long long b_stride,
                      long long s_stride, float t, int dtype, void* stream) {
  if (B <= 0 || S < 2 || P <= 0 || C <= 0 || center_t < 0 || center_t >= S ||
      slot < 0 || slot >= S) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (choose_block(dtype, C)) {
    case kBlockWgmma:
      return launch_tma_c<false>(ring, out, B, S, P, C, center_t, slot, b_stride, s_stride, t, s);
    case kBlockS8:
      return launch_tma_c<true>(ring, out, B, S, P, C, center_t, slot, b_stride, s_stride, t, s);
    case kBlockTf32:
      return launch<float>(ring, out, B, S, P, C, center_t, slot, b_stride, s_stride, t, s);
    case kBlockTile:
      return launch<bf16>(ring, out, B, S, P, C, center_t, slot, b_stride, s_stride, t, s);
    case kBlockWide:
      if (dtype == 0) {
        return launch_wide<float, float>(ring, out, B, S, P, C, center_t, slot, b_stride, s_stride, t, s);
      }
      if (dtype == 1) {
        return launch_wide<bf16, bf16>(ring, out, B, S, P, C, center_t, slot, b_stride, s_stride, t, s);
      }
      return launch_wide<int8_t, bf16>(ring, out, B, S, P, C, center_t, slot, b_stride, s_stride, t, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* dcnet_coattn_ring_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
