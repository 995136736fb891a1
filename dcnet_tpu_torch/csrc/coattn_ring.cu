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
// 3xTF32 with the unrounded weights. int8 rings (features
// quantised as clip(round(127 f)), f l2-normalised) take the logits as exact
// int32 sums on the tensor cores (WMMA s8 x s8 -> s32, m16n16k16), converted
// to fp32 and scaled by T/127^2 (|logit| <= 127^2 C < 2^24 at C <= 1040, so
// the conversion is exact); the PV product reads kv dequantised as
// bf16(bf16(kv) * bf16(1/127)), the rounding the TPU body gives it, with bf16
// weights and fp32 accumulation. The output is bf16 for int8 rings and the
// ring's dtype otherwise.
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
// reference slots by (slot + 1 + t) mod S. Four blocks, chosen by dtype
// and C in the entry point (K1's rule, dcnet_coattn_block):
//
// - bf16 rings with C % 128 == 0 and C <= 512: K1's wgmma + TMA block
//   (attend_wgmma.cuh, the design notes in coattn.cu), 64 center rows a
//   block (7,680 blocks at 120 streams and P = 1024), over one 4-D tensor
//   map (C, P, S, B) of the ring in place: TMA reads the center's rows and
//   the reference's tiles by their (slot, stream) coordinates. What bounded
//   the WMMA block here was K1's: issue, not the tensor cores.
// - fp32 rings with C % 16 == 0 and C <= 512: K1's 3xTF32 block
//   (attend_tf32.cuh), 32 center rows a block.
// - bf16 rings of other widths: K1's WMMA block of attend_tile.cuh, 32
//   center rows a block.
// - int8 rings: the int8 block below, 32 center rows, synchronous loads and
//   WMMA (its move to wgmma s8 is queued). It keeps its q rows and kv tile
//   as int8 in shared memory in a 16-byte-chunked layout ([C/16][rows][16])
//   so every WMMA fragment pointer is 256-bit aligned, and writes the
//   dequantised bf16 kv tile beside it for the PV product (212 KB of shared
//   memory at C = 512, one block per SM).
#include <type_traits>

#include "attend_tf32.cuh"
#include "attend_tile.cuh"
#include "attend_wgmma.cuh"

namespace {

using namespace dcnet;

static_assert(tf32::kRows == kBlockM, "ring_kernel's grid serves every float block");

// Threads of ring_kernel's block for ring dtype T.
template <typename T>
constexpr int kRingThreads = std::is_same<T, float>::value ? tf32::kThreads : kThreads;

// The int8 block's shared memory: the bf16 block's layout (kv_s holds the
// dequantised tile, s_s the int32 scores, q_s the int8 q rows), plus the int8
// kv tile at off_kv8.
__host__ __device__ inline Layout layout_i8(int C) {
  Layout L = layout<bf16>(C);
  L.total = L.off_kv8 + align128(Tile<bf16>::kBlockN * (size_t)C);
  return L;
}

// Copies `rows` int8 rows of C starting at `row0` of a (P, C) matrix into
// dst laid out as [C/16][rows_blk][16] (rows past P are zero) and, where
// `deq` is given, their dequantised values bf16(x * bf16(1/127)) into deq
// with pitch ld_deq.
__device__ void load_rows_i8(int8_t* dst, int rows_blk, bf16* deq, int ld_deq,
                             const int8_t* src, int row0, int rows, int P,
                             int C) {
  const float kscale = __bfloat162float(__float2bfloat16(1.0f / 127.0f));
  const int vecs = C / 16;
  for (int i = threadIdx.x; i < rows * vecs; i += kThreads) {
    const int r = i / vecs;
    const int cc = i - r * vecs;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < P) {
      v = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * C + cc * 16);
    }
    *reinterpret_cast<uint4*>(dst + ((long long)cc * rows_blk + r) * 16) = v;
    if (deq != nullptr) {
      const int8_t* e = reinterpret_cast<const int8_t*>(&v);
      uint4 packed[2];
      bf16* h = reinterpret_cast<bf16*>(packed);
#pragma unroll
      for (int k = 0; k < 16; ++k) h[k] = __float2bfloat16((float)e[k] * kscale);
      uint4* out = reinterpret_cast<uint4*>(deq + r * ld_deq + cc * 16);
      out[0] = packed[0];  // pitch (C + 8) * 2 bytes: 16-byte aligned
      out[1] = packed[1];
    }
  }
}

// s[r][n] = <q8[r], kv8[n]> as exact int32 sums, for the kBlockM x BN tile.
__device__ void tile_scores_i8(const int8_t* q8, const int8_t* kv8, int* s_i,
                               const Layout& L, int C) {
  constexpr int BN = Tile<bf16>::kBlockN;
  const int warp = threadIdx.x / 32;
  for (int f = warp; f < (kBlockM / 16) * (BN / 16); f += kWarps) {
    const int fm = f / (BN / 16), fn = f % (BN / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc;
    wmma::fill_fragment(acc, 0);
    for (int kc = 0; kc < C / 16; ++kc) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> b;
      wmma::load_matrix_sync(a, reinterpret_cast<const signed char*>(
          q8 + ((long long)kc * kBlockM + fm * 16) * 16), 16);
      wmma::load_matrix_sync(b, reinterpret_cast<const signed char*>(
          kv8 + ((long long)kc * BN + fn * 16) * 16), 16);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(s_i + fm * 16 * L.lds + fn * 16, acc, L.lds,
                            wmma::mem_row_major);
  }
}

// The int8 block: as attend_rows, with int32 logits scaled by `scale`
// (T/127^2) and the PV product on the dequantised bf16 tile.
template <typename OutT>
__device__ void attend_rows_i8(const int8_t* qb, const int8_t* kvb, OutT* ob,
                               int row0, int P, int C, float scale,
                               unsigned char* smem) {
  constexpr int BN = Tile<bf16>::kBlockN;
  const Layout L = layout_i8(C);
  int8_t* q8 = reinterpret_cast<int8_t*>(smem + L.off_q);
  bf16* kvd = reinterpret_cast<bf16*>(smem + L.off_kv);
  float* o_s = reinterpret_cast<float*>(smem + L.off_o);
  int* s_i = reinterpret_cast<int*>(smem + L.off_s);
  bf16* p_s = reinterpret_cast<bf16*>(smem + L.off_p);
  float* m_s = reinterpret_cast<float*>(smem + L.off_m);
  float* l_s = reinterpret_cast<float*>(smem + L.off_l);
  int8_t* kv8 = reinterpret_cast<int8_t*>(smem + L.off_kv8);

  load_rows_i8(q8, kBlockM, nullptr, 0, qb, row0, kBlockM, P, C);
  init_rows(o_s, m_s, l_s, L, C);
  for (int n0 = 0; n0 < P; n0 += BN) {
    __syncthreads();  // the last tile's readers of kv8, kvd and p_s are done
    load_rows_i8(kv8, BN, kvd, L.ldkv, kvb, n0, BN, P, C);
    __syncthreads();
    tile_scores_i8(q8, kv8, s_i, L, C);
    __syncthreads();
    online_softmax_tile<BN>(
        [&](int r, int j) { return (float)s_i[r * L.lds + j] * scale; }, p_s,
        o_s, m_s, l_s, L, n0, P, C);
    __syncthreads();
    tile_accumulate(p_s, kvd, o_s, L, C);
  }
  __syncthreads();
  store_rows(ob, o_s, l_s, L, row0, P, C);
}

template <typename T, typename OutT>
__global__ void __launch_bounds__(kRingThreads<T>, 1)
ring_kernel(const T* ring, OutT* out, int S, int center_t, int slot, int tiles,
            int P, int C, long long b_stride, long long s_stride, float t) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_ref = S - 1;
  const int tile = blockIdx.x % tiles;
  const int rest = blockIdx.x / tiles;
  const int r = rest % n_ref;
  const long long b = rest / n_ref;
  const int ref_t = r < center_t ? r : r + 1;
  const T* frames = ring + b * b_stride;
  const T* qb = frames + (long long)((slot + 1 + center_t) % S) * s_stride;
  const T* kvb = frames + (long long)((slot + 1 + ref_t) % S) * s_stride;
  OutT* ob = out + (b * n_ref + r) * (long long)P * C;
  if constexpr (std::is_same<T, int8_t>::value) {
    attend_rows_i8<OutT>(qb, kvb, ob, tile * kBlockM, P, C, t, smem);
  } else if constexpr (std::is_same<T, float>::value) {
    tf32::attend_rows(qb, kvb, ob, tile * kBlockM, P, C, t, smem);
  } else {
    attend_rows<T, OutT>(qb, kvb, ob, tile * kBlockM, P, C, t, smem);
  }
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

template <int C>
int launch_wgmma(const void* ring, void* out, int B, int S, int P, int center_t,
                 int slot, long long b_stride, long long s_stride, float t,
                 cudaStream_t stream) {
  CUtensorMap map;
  const uint64_t dims[4] = {(uint64_t)C, (uint64_t)P, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)C * 2, (uint64_t)s_stride * 2,
                               (uint64_t)b_stride * 2};
  const int enc = wg::encode_map(&map, ring, 4, dims, strides);
  if (enc != 0) return enc;
  const int bytes = (int)wg::smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      ring_wgmma_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear, so PyTorch's next check does not see it
    return (int)err;
  }
  const int tiles = (P + wg::kRows - 1) / wg::kRows;
  const long long blocks = (long long)B * (S - 1) * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  ring_wgmma_kernel<C><<<(unsigned)blocks, wg::kThreads, bytes, stream>>>(
      map, static_cast<bf16*>(out), S, center_t, slot, tiles, P, t);
  return (int)cudaGetLastError();
}

int launch_wgmma_c(const void* ring, void* out, int B, int S, int P, int C,
                   int center_t, int slot, long long b_stride,
                   long long s_stride, float t, cudaStream_t s) {
  switch (C) {
    case 128: return launch_wgmma<128>(ring, out, B, S, P, center_t, slot, b_stride, s_stride, t, s);
    case 256: return launch_wgmma<256>(ring, out, B, S, P, center_t, slot, b_stride, s_stride, t, s);
    case 384: return launch_wgmma<384>(ring, out, B, S, P, center_t, slot, b_stride, s_stride, t, s);
    case 512: return launch_wgmma<512>(ring, out, B, S, P, center_t, slot, b_stride, s_stride, t, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, typename OutT>
int launch(const void* ring, void* out, int B, int S, int P, int C,
           int center_t, int slot, long long b_stride, long long s_stride,
           float t, cudaStream_t stream) {
  size_t bytes;
  if constexpr (std::is_same<T, int8_t>::value) {
    bytes = layout_i8(C).total;
  } else if constexpr (std::is_same<T, float>::value) {
    bytes = tf32::smem_bytes(C);
  } else {
    bytes = layout<T>(C).total;
  }
  cudaError_t err = cudaFuncSetAttribute(
      ring_kernel<T, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear, so PyTorch's next check does not see it
    return (int)err;
  }
  const int tiles = (P + kBlockM - 1) / kBlockM;
  const long long blocks = (long long)B * (S - 1) * tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  ring_kernel<T, OutT><<<(unsigned)blocks, kRingThreads<T>, bytes, stream>>>(
      static_cast<const T*>(ring), static_cast<OutT*>(out), S, center_t, slot,
      tiles, P, C, b_stride, s_stride, t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ring: (B, S, P, C) with rows of C contiguous, batch and slot strides in
// elements; out: (B, S-1, P, C) contiguous, in the ring's dtype (bfloat16 for
// int8 rings). dtype: 0 = float32, 1 = bfloat16, 2 = int8: bf16 rings with
// C % 128 == 0, C <= 512 take the wgmma + TMA block of attend_wgmma.cuh,
// fp32 rings with C <= 512 the 3xTF32 block of attend_tf32.cuh, other bf16
// rings the block of attend_tile.cuh, int8 rings attend_rows_i8. slot is the
// physical slot of the newest frame, 0 <= slot < S. t is the softmax
// temperature for float rings and T/127^2 for int8 rings. Returns a
// cudaError_t code, 0 on success.
int dcnet_coattn_ring(const void* ring, void* out, int B, int S, int P, int C,
                      int center_t, int slot, long long b_stride,
                      long long s_stride, float t, int dtype, void* stream) {
  if (B <= 0 || S < 2 || P <= 0 || C <= 0 || C % 16 != 0 || center_t < 0 ||
      center_t >= S || slot < 0 || slot >= S) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && wg::takes(C)) {
    return launch_wgmma_c(ring, out, B, S, P, C, center_t, slot, b_stride,
                          s_stride, t, s);
  }
  if (dtype == 0) {
    if (!tf32::takes(C)) return (int)cudaErrorInvalidValue;
    return launch<float, float>(ring, out, B, S, P, C, center_t, slot,
                                b_stride, s_stride, t, s);
  }
  if (dtype == 1) {
    return launch<bf16, bf16>(ring, out, B, S, P, C, center_t, slot, b_stride,
                              s_stride, t, s);
  }
  if (dtype == 2) {
    return launch<int8_t, bf16>(ring, out, B, S, P, C, center_t, slot,
                                b_stride, s_stride, t, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* dcnet_coattn_ring_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
