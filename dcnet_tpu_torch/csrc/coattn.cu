// K1: single-direction co-attention for Hopper (sm_90a), and K2, the pair.
//
// K1 replaces dcnet_tpu/ops/pallas/coattn.py::_attend (kernel body
// _attend_kernel), reached from DCNet.corr_features through
// coattention_center_fused / coattention_one:
//
//     out[b] = softmax_rows(T * q[b] kv[b]^T) kv[b],   q, kv, out: (B, P, C)
//
// K2 replaces coattn.py::coattention_fused, the training step's pair: both
// directions (attend(f1, f2), attend(f2, f1)) in one launch whose grid spans
// the direction (blockIdx.z; z = 1 swaps the operands). The column softmax
// of f1 f2^T is the row softmax of f2 f1^T, so each direction is K1.
// Precision follows the TPU kernel: logits and softmax in fp32; bf16 inputs
// take both products on the tensor cores with fp32 accumulation and the
// softmax weights rounded to bf16 before the PV product; fp32 inputs take
// both products on the tensor cores by 3xTF32 (fp32 accuracy, the unrounded
// weights in PV; tf32x3.cuh). The output has q's dtype.
//
// Bound per launch: 4*B*P^2*C operations and 3*B*P*C*sizeof(T) bytes (q and
// kv read once, out written once), each product at the card's fastest route
// that keeps the TPU body's accuracy: 989 TFLOP/s for bf16 (exact products),
// 495 / 3 = 165 TFLOP/s for fp32 (3xTF32). On the main path (B clips,
// C = 512) the P = 1024 launch is compute-bound: 2.1 GFLOP per clip, about
// 2.2 us in bf16 and 13 us in fp32, against 3 MiB (bf16) of traffic. The
// P = 64 launch is memory-bound: about 197 KB per clip in bf16, about
// 0.06 us at 3.35 TB/s.
//
// Design. The TPU kernel keeps the whole (P, C) kv block in VMEM; at P = 1024,
// C = 512 that is 1-2 MiB, far above the 227 KB of shared memory a block may
// use. So a block owns a tile of query rows and streams kv through shared
// memory in tiles with an online softmax (running row max m and row sum l;
// the accumulator is rescaled by exp(m_old - m_new) before each tile is
// added). The (P, P) logits never leave the SM. Rows and columns past P are
// masked (zero rows in, -inf logits, no store), so ragged P (169, 676, 2704
// at 416 px) works. Four blocks, chosen by dtype and C in the entry point
// (dcnet_coattn_block, blocks.cuh), never as a fallback; every C >= 1 has
// one:
//
// - bf16 with C % 128 == 0 and C <= 512 (every configuration the repository
//   runs): the wgmma + TMA block of attend_wgmma.cuh. What bounded the
//   first block was issue, not the tensor cores: WMMA's small tiles, the
//   32 x C accumulator living in shared memory (loaded, rescaled and stored
//   every kv tile), synchronous loads and four __syncthreads a tile. Here a
//   block owns 64 rows; one thread of a third warpgroup keeps two 64 x C kv
//   tiles in flight by TMA while two warpgroups compute, each over half the
//   channels: QK^T partials on wgmma m64n64k16 from shared memory, summed
//   through 2 x 16 KB of shared memory, the softmax in registers, and PV on
//   wgmma m64n(C/2)k16 with the weights as the A operand from registers and
//   the same kv tile as the transposed B operand; the 64 x C/2 fp32
//   accumulator of each warpgroup stays in registers (setmaxnreg gives the
//   computing warpgroups 240 a thread). About 225 KB of shared memory at
//   C = 512: one block per SM. Each block still rereads kv from L2 (64 KB a
//   tile for 64 rows), the softmax does not overlap the products, and the
//   two warpgroups meet at two named barriers a tile: the next redesign's
//   targets.
// - fp32 with C % 16 == 0 and C <= 512 (every fp32 width the port
//   launches): the 3xTF32 block of attend_tf32.cuh. Both products run on
//   mma.sync m16n8k8 TF32, each fp32 operand split into a TF32 big and
//   small part in registers as its fragment is loaded (three passes, fp32
//   accuracy; one pass misses the fp32 limits). wgmma reads
//   TF32 operands K-major only, so PV could not take the kv tile as its B
//   operand as the bf16 block does; mma.sync fragments are loaded by hand
//   and take any layout. A block owns 32 q rows (a 64 x C fp32 q tile alone
//   is 128 KB); 16 warps split them into 2 row groups x 8 channel groups,
//   each keeping a 16 x C/8 fp32 accumulator in registers; kv tiles of 32
//   rows are double-buffered by cp.async; the partial logits of the eight
//   channel groups are summed through shared memory. About 226 KB of shared
//   memory at C = 512: one block per SM, and each block rereads kv from L2
//   per 32 rows.
// - bf16 at other widths with C % 16 == 0 and C <= 672 (its shared memory
//   at C = 688 would be 235,776 B): the block of attend_tile.cuh (32 rows,
//   kv tiles loaded synchronously, the accumulator in shared memory,
//   products on WMMA m16n16k16).
// - every other width (C % 16 != 0, fp32 past 512, bf16 past the WMMA
//   block's shared memory; no configuration of the repository runs one):
//   the general block of attend_wide.cuh, a block per 32 rows and output
//   chunk of at most 512 channels, on the CUDA cores, any alignment.
// The rule is blocks.cuh's choose_block. Each launch sizes its shared
// memory by the formula its block runs on and checks it against the
// 232,448 B a block may have (prepare_smem) before launching.
//
// K2 runs each block with the direction on grid.z; the wgmma block swaps
// its two tensor maps there.
//
// Row windows (the tensor-parallel co-attention, ops/coattention.py's
// tp_shard): a launch computes the query rows row0..row0+rows-1 of each
// frame against every row of the other frame, any rows >= 1 at any
// offset. The pointer blocks take q at its window's first row with Pq =
// rows for the q loads and the stores and the kv frame's P for the kv
// tiles and the column mask; the wgmma block reads the q box at row0 + its
// rows in the frame's own map and stores only the window's rows (rows past
// it, another rank's or TMA's zero fill, are computed and dropped). The
// grid spans the window's rows; K2's second direction moves its q (the
// first frame's partner) by the same row0. The window's rows are
// computed exactly as the whole frame's launch computes them (each row's
// softmax is its own), so a window equals those rows of the full launch.
#include "blocks.cuh"

namespace {

using namespace dcnet;

template <typename T>
__global__ void __launch_bounds__(kThreads)
attend_kernel(const T* q, const T* kv, T* out, T* out2, int P, int C, int row0,
              int rows, long long q_bstride, long long kv_bstride, float t) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (blockIdx.z == 1) {  // the pair's second direction: attend(kv, q)
    const T* tmp = q;
    q = kv;
    kv = tmp;
    const long long st = q_bstride;
    q_bstride = kv_bstride;
    kv_bstride = st;
    out = out2;
  }
  const long long b = blockIdx.y;
  attend_rows<T, T>(q + b * q_bstride + (long long)row0 * C, kv + b * kv_bstride,
                    out + b * rows * C, blockIdx.x * kBlockM, rows, P, C, t, smem);
}

// The fp32 block on the tensor cores by 3xTF32 (attend_tf32.cuh).
__global__ void __launch_bounds__(tf32::kThreads, 1)
attend_tf32_kernel(const float* q, const float* kv, float* out, float* out2,
                   int P, int C, int row0, int rows, long long q_bstride,
                   long long kv_bstride, float t) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (blockIdx.z == 1) {  // the pair's second direction: attend(kv, q)
    const float* tmp = q;
    q = kv;
    kv = tmp;
    const long long st = q_bstride;
    q_bstride = kv_bstride;
    kv_bstride = st;
    out = out2;
  }
  const long long b = blockIdx.y;
  tf32::attend_rows(q + b * q_bstride + (long long)row0 * C, kv + b * kv_bstride,
                    out + b * rows * C, blockIdx.x * tf32::kRows, rows, P, C, t, smem);
}

// The bf16 block on wgmma + TMA; maps (C, P, B) of the whole q and kv
// frames, the window's rows read at row0 + the block's rows. z = 1 swaps
// the maps (the pair's second direction).
template <int C>
__global__ void __launch_bounds__(wg::kThreads, 1)
attend_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_kv, bf16* out,
                    bf16* out2, int P, int row0, int rows, float t) {
  extern __shared__ __align__(128) unsigned char smem[];  // aligned to 1024 inside
  const bool swap = blockIdx.z == 1;
  const int b = blockIdx.y;
  wg::attend_rows<C, 3>(swap ? &map_kv : &map_q, {b, 0}, swap ? &map_q : &map_kv,
                        {b, 0}, (swap ? out2 : out) + (long long)b * rows * C,
                        blockIdx.x * wg::kRows, row0, rows, P, t, smem);
}

// The general block (attend_wide.cuh): grid.z = direction x output chunk.
template <typename T, int NC>
__global__ void __launch_bounds__(wide::kThreads, 1)
attend_wide_kernel(const T* q, const T* kv, T* out, T* out2, int P, int C, int row0,
                   int rows, long long q_bstride, long long kv_bstride, float t,
                   int nch) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (blockIdx.z >= nch) {  // the pair's second direction: attend(kv, q)
    const T* tmp = q;
    q = kv;
    kv = tmp;
    const long long st = q_bstride;
    q_bstride = kv_bstride;
    kv_bstride = st;
    out = out2;
  }
  const long long b = blockIdx.y;
  wide::attend_rows<NC, T, T>(q + b * q_bstride + (long long)row0 * C, kv + b * kv_bstride,
                              out + b * rows * C, blockIdx.x * wide::kRows,
                              (blockIdx.z % nch) * NC, rows, P, C, t, smem);
}

template <typename T, int NC>
int launch_wide_nc(const void* q, const void* kv, void* out, void* out2, int B,
                   int P, int C, int row0, int rows, long long q_bstride,
                   long long kv_bstride, float t, cudaStream_t stream) {
  const size_t bytes = wide::layout<T>(NC, 1).total;
  const int err = prepare_smem(attend_wide_kernel<T, NC>, bytes);
  if (err != 0) return err;
  const int nch = wide::chunks(C);
  const dim3 grid((rows + wide::kRows - 1) / wide::kRows, B, (out2 ? 2 : 1) * nch);
  attend_wide_kernel<T, NC><<<grid, wide::kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv), static_cast<T*>(out),
      static_cast<T*>(out2), P, C, row0, rows, q_bstride, kv_bstride, t, nch);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wide(const void* q, const void* kv, void* out, void* out2, int B, int P,
                int C, int row0, int rows, long long q_bstride, long long kv_bstride,
                float t, cudaStream_t s) {
  return wide::with_chunk(C, [&](auto nc) {
    return launch_wide_nc<T, decltype(nc)::value>(q, kv, out, out2, B, P, C, row0, rows,
                                                  q_bstride, kv_bstride, t, s);
  });
}

template <typename T>
int launch(const void* q, const void* kv, void* out, void* out2, int B, int P,
           int C, int row0, int rows, long long q_bstride, long long kv_bstride,
           float t, cudaStream_t stream) {
  const Layout L = layout<T>(C);
  const int err = prepare_smem(attend_kernel<T>, L.total);
  if (err != 0) return err;
  const dim3 grid((rows + kBlockM - 1) / kBlockM, B, out2 ? 2 : 1);
  attend_kernel<T><<<grid, kThreads, L.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv), static_cast<T*>(out),
      static_cast<T*>(out2), P, C, row0, rows, q_bstride, kv_bstride, t);
  return (int)cudaGetLastError();
}

int launch_tf32(const void* q, const void* kv, void* out, void* out2, int B,
                int P, int C, int row0, int rows, long long q_bstride,
                long long kv_bstride, float t, cudaStream_t stream) {
  const size_t bytes = tf32::smem_bytes(C);
  const int err = prepare_smem(attend_tf32_kernel, bytes);
  if (err != 0) return err;
  const dim3 grid((rows + tf32::kRows - 1) / tf32::kRows, B, out2 ? 2 : 1);
  attend_tf32_kernel<<<grid, tf32::kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kv),
      static_cast<float*>(out), static_cast<float*>(out2), P, C, row0, rows,
      q_bstride, kv_bstride, t);
  return (int)cudaGetLastError();
}

template <int C>
int launch_wgmma(const void* q, const void* kv, void* out, void* out2, int B,
                 int P, int row0, int rows, long long q_bstride, long long kv_bstride,
                 float t, cudaStream_t stream) {
  CUtensorMap maps[2];
  const void* bases[2] = {q, kv};
  const long long bstrides[2] = {q_bstride, kv_bstride};
  for (int i = 0; i < 2; ++i) {
    const uint64_t dims[3] = {(uint64_t)C, (uint64_t)P, (uint64_t)B};
    const uint64_t strides[2] = {(uint64_t)C * 2, (uint64_t)bstrides[i] * 2};
    const int err = wg::encode_map(&maps[i], bases[i], 3, dims, strides);
    if (err != 0) return err;
  }
  const size_t bytes = wg::smem_bytes(C);
  const int err = prepare_smem(attend_wgmma_kernel<C>, bytes);
  if (err != 0) return err;
  const dim3 grid((rows + wg::kRows - 1) / wg::kRows, B, out2 ? 2 : 1);
  attend_wgmma_kernel<C><<<grid, wg::kThreads, bytes, stream>>>(
      maps[0], maps[1], static_cast<bf16*>(out), static_cast<bf16*>(out2), P, row0,
      rows, t);
  return (int)cudaGetLastError();
}

int launch_wgmma_c(const void* q, const void* kv, void* out, void* out2, int B,
                   int P, int C, int row0, int rows, long long q_bstride,
                   long long kv_bstride, float t, cudaStream_t s) {
  switch (C) {
    case 128: return launch_wgmma<128>(q, kv, out, out2, B, P, row0, rows, q_bstride, kv_bstride, t, s);
    case 256: return launch_wgmma<256>(q, kv, out, out2, B, P, row0, rows, q_bstride, kv_bstride, t, s);
    case 384: return launch_wgmma<384>(q, kv, out, out2, B, P, row0, rows, q_bstride, kv_bstride, t, s);
    case 512: return launch_wgmma<512>(q, kv, out, out2, B, P, row0, rows, q_bstride, kv_bstride, t, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = int8 (K4's rings). The block each
// launch takes, by shape (blocks.cuh): 1 = the bf16 wgmma + TMA block, 2 =
// the fp32 3xTF32 block, 0 = the bf16 WMMA block, 4 = the int8 wgmma s8 +
// TMA block, 3 = the general block; -1 for C < 1 or another dtype. K4's
// entry point applies the same rule to its rings.
int dcnet_coattn_block(int dtype, int C) { return choose_block(dtype, C); }

// q and kv are (B, P, C) frames; strides are in elements; rows of q and kv
// are contiguous (row stride C). The launch computes the row window
// row0..row0+rows-1 (any rows >= 1 at any offset, row0 + rows <= P): with
// out2 null this is K1 (out = attend(q[:, window], kv)); otherwise K2 (out =
// attend(q[:, window], kv), out2 = attend(kv[:, window], q)). out and out2
// are (B, rows, C) and contiguous; row0 = 0, rows = P is the whole frame.
// Returns a cudaError_t code, 0 on success.
int dcnet_coattn_attend(const void* q, const void* kv, void* out, void* out2,
                        int B, int P, int C, int row0, int rows,
                        long long q_bstride, long long kv_bstride, float t,
                        int dtype, void* stream) {
  if (B <= 0 || P <= 0 || C <= 0 || B > 65535 || dtype < 0 || dtype > 1 ||
      row0 < 0 || rows < 1 || row0 > P - rows) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int r0 = row0, n = rows;
  switch (choose_block(dtype, C)) {
    case kBlockWgmma:
      return launch_wgmma_c(q, kv, out, out2, B, P, C, r0, n, q_bstride, kv_bstride, t, s);
    case kBlockTf32:
      return launch_tf32(q, kv, out, out2, B, P, C, r0, n, q_bstride, kv_bstride, t, s);
    case kBlockTile:
      return launch<bf16>(q, kv, out, out2, B, P, C, r0, n, q_bstride, kv_bstride, t, s);
    case kBlockWide:
      return dtype == 0
                 ? launch_wide<float>(q, kv, out, out2, B, P, C, r0, n, q_bstride, kv_bstride, t, s)
                 : launch_wide<bf16>(q, kv, out, out2, B, P, C, r0, n, q_bstride, kv_bstride, t, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* dcnet_coattn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
