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
// take both products on the tensor cores (WMMA m16n16k16, fp32 accumulate)
// with the softmax weights rounded to bf16 before the PV product; fp32
// inputs use fp32 FMA throughout. The output has q's dtype.
//
// Bound per launch: 4*B*P^2*C operations and 3*B*P*C*sizeof(T) bytes (q and
// kv read once, out written once). On the main path (B clips, C = 512) the
// P = 1024 launch is compute-bound: 2.1 GFLOP per clip, about 2.2 us at the
// H100's 989 TFLOP/s bf16 data-sheet rate, against 3 MiB of traffic. The
// P = 64 launch is memory-bound: about 197 KB per clip, about 0.06 us at
// 3.35 TB/s.
//
// Design. The TPU kernel keeps the whole (P, C) kv block in VMEM; at P = 1024,
// C = 512 that is 1-2 MiB, far above the 227 KB of shared memory a block may
// use. So a block owns BLOCK_M = 32 query rows and streams kv through shared
// memory in tiles of BLOCK_N rows with an online softmax (running row max m
// and row sum l; the accumulator is rescaled by exp(m_old - m_new) before
// each tile is added). The (P, P) logits never leave the SM. The 32 x C fp32
// accumulator (64 KB at C = 512) does not fit one warpgroup's registers next
// to the WMMA fragments, so it lives in shared memory: each tile loads,
// updates and stores its fragments there. Rows and columns past P are
// masked (zero rows in, -inf logits, no store), so ragged P (169, 676, 2704
// at 416 px) works. Against the compute bound this first kernel gives away
// speed on purpose: synchronous tile loads (no cp.async/TMA pipeline),
// WMMA instead of wgmma, and one block per SM (about 180 KB of shared
// memory per block); each block rereads kv from L2, which BLOCK_M = 32
// amortises over 32 rows. The block's device code is attend_tile.cuh,
// shared with K4 (coattn_ring.cu).
#include "attend_tile.cuh"

namespace {

using namespace dcnet;

template <typename T>
__global__ void __launch_bounds__(kThreads)
attend_kernel(const T* q, const T* kv, T* out, T* out2, int P, int C,
              long long q_bstride, long long kv_bstride, float t) {
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
  attend_rows<T, T>(q + b * q_bstride, kv + b * kv_bstride, out + b * P * C,
                    blockIdx.x * kBlockM, P, C, t, smem);
}

template <typename T>
int launch(const void* q, const void* kv, void* out, void* out2, int B, int P,
           int C, long long q_bstride, long long kv_bstride, float t,
           cudaStream_t stream) {
  const Layout L = layout<T>(C);
  cudaError_t err = cudaFuncSetAttribute(
      attend_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.total);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear, so PyTorch's next check does not see it
    return (int)err;
  }
  const dim3 grid((P + kBlockM - 1) / kBlockM, B, out2 ? 2 : 1);
  attend_kernel<T><<<grid, kThreads, L.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv), static_cast<T*>(out),
      static_cast<T*>(out2), P, C, q_bstride, kv_bstride, t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; rows of q and
// kv are contiguous (row stride C). With out2 null this is K1 (out =
// attend(q, kv)); otherwise K2 (out = attend(q, kv), out2 = attend(kv, q)).
// Returns a cudaError_t code, 0 on success.
int dcnet_coattn_attend(const void* q, const void* kv, void* out, void* out2,
                        int B, int P, int C, long long q_bstride,
                        long long kv_bstride, float t, int dtype, void* stream) {
  if (B <= 0 || P <= 0 || C <= 0 || C % 16 != 0 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(q, kv, out, out2, B, P, C, q_bstride, kv_bstride, t, s);
  }
  if (dtype == 1) {
    return launch<bf16>(q, kv, out, out2, B, P, C, q_bstride, kv_bstride, t, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* dcnet_coattn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
