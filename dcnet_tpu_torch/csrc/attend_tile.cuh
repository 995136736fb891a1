// Device code shared by K1/K2 (coattn.cu) and K4 (coattn_ring.cu) for bf16
// at the widths the wgmma block (attend_wgmma.cuh) does not take and whose
// shared memory fits a block (`takes`: C % 16 == 0, C < 688); wider bf16
// goes to the general block (attend_wide.cuh). One block computes softmax_rows(T * q kv^T) kv for
// kBlockM rows of q against a whole (P, C) kv frame, streaming kv through
// shared memory in tiles of BLOCK_N rows with an online softmax (running row
// max m and row sum l; the accumulator is rescaled by exp(m_old - m_new)
// before each tile is added). The 32 x C fp32 accumulator lives in shared
// memory. Rows and columns past P are masked (zero rows in, -inf logits, no
// store). Both products run on the tensor cores (WMMA m16n16k16, fp32
// accumulate) with the softmax weights rounded to bf16 before the PV
// product. fp32 inputs take the block of attend_tf32.cuh. The design notes
// (bounds, what is given away on purpose) are in coattn.cu.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "attend_wide.cuh"

namespace dcnet {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockM = 32;

template <typename T>
struct Tile;

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

// Shared memory of one block: q rows (kBlockM x C), one kv tile (BN x C) in
// T, the fp32 accumulator, the tile's fp32 scores, its softmax weights in T,
// and the running max and sum of each row.
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

// The bf16 widths this block takes: whole 16-channel WMMA fragments and a
// layout within a block's shared memory (C <= 672; 688 needs 235,776 B).
__host__ __device__ inline bool tile_takes(int C) {
  return C % 16 == 0 && C >= 16 && layout<bf16>(C).total <= kSmemLimit;
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
__device__ inline bf16 from_float<bf16>(float v) { return __float2bfloat16(v); }

// Copies `rows` bf16 rows of C elements starting at row `row0` of a (P, C)
// row-major matrix into shared memory with pitch `ld`; rows past P are
// zero. Global reads are 16-byte vectors (the host checks alignment).
template <typename T>
__device__ void load_rows(T* dst, int ld, const T* src, int row0, int rows,
                          int P, int C) {
  static_assert(sizeof(T) == 2, "fp32 takes the block of attend_tf32.cuh");
  constexpr int V = 16 / sizeof(T);
  const int vecs = C / V;
  for (int i = threadIdx.x; i < rows * vecs; i += kThreads) {
    const int r = i / vecs;
    const int c = (i - r * vecs) * V;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < P) {
      v = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * C + c);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;  // pitch (C + 8) * 2 bytes: aligned
  }
}

// s[r][n] = <q_s[r], kv_s[n]> for the kBlockM x BN tile.
__device__ inline void tile_scores(const bf16* q_s, const bf16* kv_s, float* s_s,
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
__device__ inline void tile_accumulate(const bf16* p_s, const bf16* kv_s,
                                       float* o_s, const Layout& L, int C) {
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

// Zeroes the accumulator and sets each row's running max to -inf and its
// running sum to 0.
__device__ inline void init_rows(float* o_s, float* m_s, float* l_s,
                                 const Layout& L, int C) {
  for (int i = threadIdx.x; i < kBlockM * C; i += kThreads) {
    o_s[(i / C) * L.ldo + i % C] = 0.f;
  }
  for (int r = threadIdx.x; r < kBlockM; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
}

// One tile's online-softmax step, one warp per row. `logit(r, j)` gives the
// scaled logit of row r against the tile's column j; columns past P get -inf.
// Writes exp(logit - m_new) into p_s (rounded to PT), rescales the row's
// accumulator by exp(m_old - m_new) and updates m and l.
template <int BN, typename PT, typename Logit>
__device__ inline void online_softmax_tile(Logit logit, PT* p_s, float* o_s,
                                           float* m_s, float* l_s,
                                           const Layout& L, int n0, int P,
                                           int C) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kBlockM; r += kWarps) {
    float v[BN / 32];
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < BN / 32; ++k) {
      const int j = lane + 32 * k;
      v[k] = (n0 + j < P) ? logit(r, j) : -INFINITY;
      mx = fmaxf(mx, v[k]);
    }
    mx = warp_max(mx);
    const float m_old = m_s[r];
    const float m_new = fmaxf(m_old, mx);  // finite: column n0 < P is valid
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < BN / 32; ++k) {
      const float e = expf(v[k] - m_new);
      p_s[r * L.ldp + lane + 32 * k] = from_float<PT>(e);
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
}

// Writes rows row0.. of the normalised accumulator, o / l, into the (P, C)
// output frame `ob` (rows past P are not stored).
template <typename OutT>
__device__ inline void store_rows(OutT* ob, const float* o_s, const float* l_s,
                                  const Layout& L, int row0, int P, int C) {
  OutT* o = ob + (long long)row0 * C;
  for (int i = threadIdx.x; i < kBlockM * C; i += kThreads) {
    const int r = i / C, c = i % C;
    if (row0 + r < P) o[(long long)r * C + c] = from_float<OutT>(o_s[r * L.ldo + c] / l_s[r]);
  }
}

// The block's whole computation for rows row0..row0+kBlockM-1 of the
// (Pq, C) frame q against the (P, C) frame kv (row stride C), written to
// the (Pq, C) frame `ob`. Pq < P is a row window of a larger q frame (qb at
// its first row); K4 passes Pq = P.
template <typename T, typename OutT>
__device__ void attend_rows(const T* qb, const T* kvb, OutT* ob, int row0,
                            int Pq, int P, int C, float t, unsigned char* smem) {
  constexpr int BN = Tile<T>::kBlockN;
  const Layout L = layout<T>(C);
  T* q_s = reinterpret_cast<T*>(smem + L.off_q);
  T* kv_s = reinterpret_cast<T*>(smem + L.off_kv);
  float* o_s = reinterpret_cast<float*>(smem + L.off_o);
  float* s_s = reinterpret_cast<float*>(smem + L.off_s);
  T* p_s = reinterpret_cast<T*>(smem + L.off_p);
  float* m_s = reinterpret_cast<float*>(smem + L.off_m);
  float* l_s = reinterpret_cast<float*>(smem + L.off_l);

  load_rows(q_s, L.ldq, qb, row0, kBlockM, Pq, C);
  init_rows(o_s, m_s, l_s, L, C);
  for (int n0 = 0; n0 < P; n0 += BN) {
    __syncthreads();  // the last tile's readers of kv_s and p_s are done
    load_rows(kv_s, L.ldkv, kvb, n0, BN, P, C);
    __syncthreads();
    tile_scores(q_s, kv_s, s_s, L, C);
    __syncthreads();
    online_softmax_tile<BN>(
        [&](int r, int j) { return s_s[r * L.lds + j] * t; }, p_s, o_s, m_s,
        l_s, L, n0, P, C);
    __syncthreads();
    tile_accumulate(p_s, kv_s, o_s, L, C);
  }
  __syncthreads();
  store_rows(ob, o_s, l_s, L, row0, Pq, C);
}

}  // namespace dcnet
