// K1: single-direction co-attention for Hopper (sm_90a).
//
// Replaces dcnet_tpu/ops/pallas/coattn.py::_attend (kernel body
// _attend_kernel), reached from DCNet.corr_features through
// coattention_center_fused / coattention_one:
//
//     out[b] = softmax_rows(T * q[b] kv[b]^T) kv[b],   q, kv, out: (B, P, C)
//
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
// amortises over 32 rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockM = 32;

template <typename T>
struct Tile;

template <>
struct Tile<float> {
  static constexpr int kBlockN = 32;  // one kv row per lane in the FMA loops
  static constexpr int kPadQ = 4;     // q rows are read as warp broadcasts
  static constexpr int kPadKV = 1;    // lanes walk kv rows at one k: pitch C+1
                                      // puts them in 32 distinct banks
};

template <>
struct Tile<bf16> {
  static constexpr int kBlockN = 64;  // 2 x 4 WMMA fragments: one per warp
  static constexpr int kPadQ = 8;     // pitches keep every fragment pointer
  static constexpr int kPadKV = 8;    // 32-byte aligned and shift the banks
};

struct Layout {
  int ldq, ldkv, ldo, lds, ldp;
  size_t off_q, off_kv, off_o, off_s, off_p, off_m, off_l, total;
};

__host__ __device__ inline size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

template <typename T>
__host__ __device__ inline Layout layout(int C) {
  constexpr int BN = Tile<T>::kBlockN;
  Layout L;
  L.ldq = C + Tile<T>::kPadQ;
  L.ldkv = C + Tile<T>::kPadKV;
  L.ldo = C + 4;
  L.lds = BN + 4;
  L.ldp = BN + 8;
  size_t off = 0;
  L.off_q = off;  off += align128(sizeof(T) * kBlockM * L.ldq);
  L.off_kv = off; off += align128(sizeof(T) * BN * L.ldkv);
  L.off_o = off;  off += align128(sizeof(float) * kBlockM * L.ldo);
  L.off_s = off;  off += align128(sizeof(float) * kBlockM * L.lds);
  L.off_p = off;  off += align128(sizeof(T) * kBlockM * L.ldp);
  L.off_m = off;  off += align128(sizeof(float) * kBlockM);
  L.off_l = off;  off += align128(sizeof(float) * kBlockM);
  L.total = off;
  return L;
}

__device__ inline float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__device__ inline T from_float(float v);
template <>
__device__ inline float from_float<float>(float v) { return v; }
template <>
__device__ inline bf16 from_float<bf16>(float v) { return __float2bfloat16(v); }

// Copies `rows` rows of C elements starting at row `row0` of a (P, C)
// row-major matrix into shared memory with pitch `ld`; rows past P are
// zero. Global reads are 16-byte vectors (the host checks alignment).
template <typename T>
__device__ void load_rows(T* dst, int ld, const T* src, int row0, int rows,
                          int P, int C) {
  constexpr int V = 16 / sizeof(T);
  const int vecs = C / V;
  for (int i = threadIdx.x; i < rows * vecs; i += kThreads) {
    const int r = i / vecs;
    const int c = (i - r * vecs) * V;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < P) {
      v = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * C + c);
    }
    T* d = dst + r * ld + c;
    if constexpr (sizeof(T) == 2) {
      *reinterpret_cast<uint4*>(d) = v;  // pitch (C + 8) * 2 bytes: aligned
    } else {
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int k = 0; k < V; ++k) d[k] = e[k];
    }
  }
}

// s[r][n] = <q_s[r], kv_s[n]> for the kBlockM x BN tile.
__device__ void tile_scores(const float* q_s, const float* kv_s, float* s_s,
                            const Layout& L, int C) {
  constexpr int R = kBlockM / kWarps;
  const int warp = threadIdx.x / 32, n = threadIdx.x % 32;
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  const float* kr = kv_s + n * L.ldkv;
  for (int k = 0; k < C; ++k) {
    const float b = kr[k];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = fmaf(q_s[(warp + i * kWarps) * L.ldq + k], b, acc[i]);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) s_s[(warp + i * kWarps) * L.lds + n] = acc[i];
}

__device__ void tile_scores(const bf16* q_s, const bf16* kv_s, float* s_s,
                            const Layout& L, int C) {
  constexpr int BN = Tile<bf16>::kBlockN;
  const int warp = threadIdx.x / 32;
  for (int f = warp; f < (kBlockM / 16) * (BN / 16); f += kWarps) {
    const int fm = f / (BN / 16), fn = f % (BN / 16);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int k = 0; k < C; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, q_s + fm * 16 * L.ldq + k, L.ldq);
      wmma::load_matrix_sync(b, kv_s + fn * 16 * L.ldkv + k, L.ldkv);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(s_s + fm * 16 * L.lds + fn * 16, acc, L.lds,
                            wmma::mem_row_major);
  }
}

// o_s[r][c] += sum_j p_s[r][j] * kv_s[j][c] over the tile's BN kv rows.
__device__ void tile_accumulate(const float* p_s, const float* kv_s, float* o_s,
                                const Layout& L, int C) {
  constexpr int BN = Tile<float>::kBlockN;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float col[BN];
#pragma unroll
    for (int j = 0; j < BN; ++j) col[j] = kv_s[j * L.ldkv + c];
    for (int r = 0; r < kBlockM; ++r) {
      float acc = o_s[r * L.ldo + c];
#pragma unroll
      for (int j = 0; j < BN; ++j) acc = fmaf(p_s[r * L.ldp + j], col[j], acc);
      o_s[r * L.ldo + c] = acc;
    }
  }
}

__device__ void tile_accumulate(const bf16* p_s, const bf16* kv_s, float* o_s,
                                const Layout& L, int C) {
  constexpr int BN = Tile<bf16>::kBlockN;
  const int warp = threadIdx.x / 32;
  const int frags_c = C / 16;
  for (int f = warp; f < (kBlockM / 16) * frags_c; f += kWarps) {
    const int fm = f / frags_c, fc = f % frags_c;
    float* optr = o_s + fm * 16 * L.ldo + fc * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, optr, L.ldo, wmma::mem_row_major);
#pragma unroll
    for (int k = 0; k < BN; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, p_s + fm * 16 * L.ldp + k, L.ldp);
      wmma::load_matrix_sync(b, kv_s + k * L.ldkv + fc * 16, L.ldkv);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(optr, acc, L.ldo, wmma::mem_row_major);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attend_kernel(const T* __restrict__ q, const T* __restrict__ kv,
              T* __restrict__ out, int P, int C, long long q_bstride,
              long long kv_bstride, float t) {
  constexpr int BN = Tile<T>::kBlockN;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout<T>(C);
  T* q_s = reinterpret_cast<T*>(smem + L.off_q);
  T* kv_s = reinterpret_cast<T*>(smem + L.off_kv);
  float* o_s = reinterpret_cast<float*>(smem + L.off_o);
  float* s_s = reinterpret_cast<float*>(smem + L.off_s);
  T* p_s = reinterpret_cast<T*>(smem + L.off_p);
  float* m_s = reinterpret_cast<float*>(smem + L.off_m);
  float* l_s = reinterpret_cast<float*>(smem + L.off_l);

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kBlockM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qb = q + (long long)b * q_bstride;
  const T* kvb = kv + (long long)b * kv_bstride;

  load_rows(q_s, L.ldq, qb, row0, kBlockM, P, C);
  for (int i = threadIdx.x; i < kBlockM * C; i += kThreads) {
    o_s[(i / C) * L.ldo + i % C] = 0.f;
  }
  for (int r = threadIdx.x; r < kBlockM; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  for (int n0 = 0; n0 < P; n0 += BN) {
    __syncthreads();  // the last tile's readers of kv_s and p_s are done
    load_rows(kv_s, L.ldkv, kvb, n0, BN, P, C);
    __syncthreads();
    tile_scores(q_s, kv_s, s_s, L, C);
    __syncthreads();
    // online softmax, one warp per row; columns past P get -inf logits
    for (int r = warp; r < kBlockM; r += kWarps) {
      float v[BN / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int k = 0; k < BN / 32; ++k) {
        const int j = lane + 32 * k;
        v[k] = (n0 + j < P) ? s_s[r * L.lds + j] * t : -INFINITY;
        mx = fmaxf(mx, v[k]);
      }
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);  // finite: column n0 < P is valid
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < BN / 32; ++k) {
        const float e = expf(v[k] - m_new);
        p_s[r * L.ldp + lane + 32 * k] = from_float<T>(e);
        sum += e;
      }
      sum = warp_sum(sum);
      const float alpha = expf(m_old - m_new);  // 0 on the first tile
      for (int c = lane; c < C; c += 32) o_s[r * L.ldo + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
      }
    }
    __syncthreads();
    tile_accumulate(p_s, kv_s, o_s, L, C);
  }
  __syncthreads();

  T* ob = out + ((long long)b * P + row0) * C;
  for (int i = threadIdx.x; i < kBlockM * C; i += kThreads) {
    const int r = i / C, c = i % C;
    if (row0 + r < P) ob[(long long)r * C + c] = from_float<T>(o_s[r * L.ldo + c] / l_s[r]);
  }
}

template <typename T>
int launch(const void* q, const void* kv, void* out, int B, int P, int C,
           long long q_bstride, long long kv_bstride, float t,
           cudaStream_t stream) {
  const Layout L = layout<T>(C);
  cudaError_t err = cudaFuncSetAttribute(
      attend_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.total);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear, so PyTorch's next check does not see it
    return (int)err;
  }
  const dim3 grid((P + kBlockM - 1) / kBlockM, B);
  attend_kernel<T><<<grid, kThreads, L.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv), static_cast<T*>(out),
      P, C, q_bstride, kv_bstride, t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; rows of q and
// kv are contiguous (row stride C). Returns a cudaError_t code, 0 on success.
int dcnet_coattn_attend(const void* q, const void* kv, void* out, int B, int P,
                        int C, long long q_bstride, long long kv_bstride,
                        float t, int dtype, void* stream) {
  if (B <= 0 || P <= 0 || C <= 0 || C % 16 != 0 || B > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, kv, out, B, P, C, q_bstride, kv_bstride, t, s);
  if (dtype == 1) return launch<bf16>(q, kv, out, B, P, C, q_bstride, kv_bstride, t, s);
  return (int)cudaErrorInvalidValue;
}

const char* dcnet_coattn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
