// K5: the fused location Gram for Hopper (sm_90a), by the rank-E algorithm.
//
// Replaces dcnet_tpu/ops/pallas/locgram.py::fused_loc_gram (kernel body
// _kernel), the location branch of the reference model:
//
//     out[b] = ReLU((ce[b] ce[b]^T * obj[b][None, :]) W + bias)
//
// ce (B, P, E) in fp32 or bf16, obj (B, P) fp32, W (P, C) fp32 (BatchNorm
// already folded in), bias (C,) fp32; out (B, P, C) in ce's dtype, for any
// B, P, E, C >= 1. The TPU kernel forms each row tile's (R, P) Gram in VMEM
// and multiplies it by W: 2*B*P^2*(E + C) operations. ce ce^T has rank <= E,
// so the same function is, exactly,
//
//     M[b]   = ce[b]^T (obj[b][:, None] * W)     (E, C), fp32
//     out[b] = ReLU(ce[b] M[b] + bias)           (P, C), rounded once
//
// 4*B*P*E*C operations, P/(2E) = 84x fewer at P = 1344, E = 8. The JAX
// package's trunk computes this factorisation by XLA ops and never calls the
// TPU kernel; no path of the port calls this one either (chip_smoke.py's
// kernel phase and kernel_timing.py launch it).
//
// Bound per launch: 4*(B*P*(E + 1) + P*C + C) bytes read (ce at its
// itemsize) and B*P*C*itemsize written. At B = 8, P = 1344, C = 512, E = 8
// in fp32 that is 2.8 MB read and 22 MB written, 0.0075 ms at 3.35 TB/s,
// against 0.18 GFLOP (0.0026 ms at the 67 TFLOP/s of fp32 FMA): bound by
// the bytes of the output. The work is ~2 FMA per output byte, far below
// the card's ridge, so plain fp32 FMA on the CUDA cores; tensor cores would
// only add rounding modes.
//
// Design: two launches, no atomics, bitwise reproducible (every sum runs in
// an order fixed by the shapes).
//   1. factor: M for all batch rows at once is one matrix product,
//      (B*E x P) (P x C), with A[b*E + e][p] = ce[b][p][e] obj[b][p]. A
//      block computes an R x 128 tile of it (R = 64, or 32 / 16 when B*E
//      <= 32 / 16) over one split of P: 128 threads, R/8 x 8 fp32 outputs
//      each (two float4 of A and two of W a 64-FMA step at R = 64), two
//      blocks an SM so that one block's loads overlap another's sums, k-tiles
//      of 32 rows of A and W in shared memory, W by cp.async and the next A
//      tile through registers while the current one is summed; W comes from
//      L2 once per R/E batch rows, not once per batch row. The S splits of
//      a tile (a power of two chosen from the shapes, `splits`, so that the
//      grid gives each of the 132 SMs about two blocks; S <= 16) form one
//      thread block cluster: each block leaves its partial tile in its shared memory,
//      and after a cluster barrier block r sums rows r R/S .. of all S
//      tiles through distributed shared memory, in rank order, and writes
//      them to M (B, E, C) fp32, a workspace the caller allocates. The
//      partials never reach device memory.
//   2. expand: a block owns one batch row, a chunk of 256 columns (one
//      16-byte vector a thread: 4 fp32 or 8 bf16 columns, so a warp's
//      store covers 512 contiguous bytes) and a range of rows. It stages
//      its chunk of M in shared memory (E x 256 fp32, 8 KB at E = 8), then
//      walks its rows in sub-tiles of 8 rows a thread, staging their ce as
//      fp32: E FMAs an element, the bias, ReLU, one rounding to ce's dtype,
//      streaming stores (st.global.cs: nothing rereads the output). Row
//      ranges grow with the batch (about four blocks an SM). This pass
//      moves the function's bytes.
// E runs in chunks of kEC coordinates in the expansion, the least power of
// two >= min(E, 16) (a template parameter: E = 8 does 8 FMAs an element,
// not 16); E > 16 loops over chunks, coordinates past E read as zero (the
// factor takes any E: its rows are (b, e) pairs). Rows past P are not read
// or stored. Columns past C read as zero and are not stored; stores and W
// loads take 16-byte vectors where the row pitch and the pointer allow it
// and single elements otherwise (C % 4 != 0 in fp32, C % 8 != 0 in bf16).
// bf16 ce is widened on load; every sum is fp32.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "smem.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kSMs = 132;
// pass 1: an R x 128 tile of the (B*E, C) factor a block of 128 threads: 8
// row groups of RPT rows x 16 column groups of 8 columns (4 at 4 tx, 4 at
// 64 + 4 tx), RPT x 8 outputs a thread; two or more blocks an SM (at most
// 255 registers a thread: at 128 the 64 sums spilled)
constexpr int kFThreads = 128;
constexpr int kFCols = 128;
constexpr int kFGroups = 16;                       // column groups
constexpr int kFTile = 32;                         // rows of P per k-tile
constexpr int kMaxSplits = 16;                     // cluster size, at most
constexpr int kFBlocksPerSM = 2;
template <int RPT>
constexpr int kFRows = kFThreads / kFGroups * RPT;
template <int RPT>
constexpr size_t kFactorSmem = sizeof(float) * 2 * kFTile * (kFRows<RPT> + kFCols);
// pass 2: 256 threads, 256 columns a block, one 16-byte vector a thread, 8
// rows a thread per sub-tile
constexpr int kXThreads = 256;
constexpr int kXCols = 256;
constexpr int kMaxEC = 16;
constexpr int kXPerThread = 8;
constexpr int kXBlocksPerSM = 4;

template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);  // columns a thread: 4 fp32, 8 bf16
template <typename T>
constexpr int kXLanes = kXCols / kVec<T>;  // threads a row
template <typename T>
constexpr int kXSub = kXThreads / kXLanes<T> * kXPerThread;  // rows a sub-tile
template <typename T, int kEC>
constexpr size_t kExpandSmem = sizeof(float) * (kEC * kXCols + kXSub<T> * kEC);

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// The splits S of P for pass 1 over `tiles` output tiles: a power of two
// (the cluster's size), as many as give about kFBlocksPerSM blocks an SM,
// at most kMaxSplits and at most the k-tiles of P. Split z takes k-tiles
// z ktiles / S .. (z + 1) ktiles / S - 1, none empty.
int splits(int tiles, int P) {
  const long long want = (kFBlocksPerSM * kSMs + tiles - 1) / tiles;
  const long long most = std::min<long long>({want, (P + kFTile - 1) / kFTile, kMaxSplits});
  int s = 1;
  while (2 * s <= most) s *= 2;
  return s;
}

// ---- pass 1 ------------------------------------------------------------

// 16 bytes (4 bytes where !vec) from global src to shared dst, or zeros.
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid, bool vec) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// W rows k0 .. k0 + kFTile - 1 (zeros from p1 on), columns c0 .. c0 + 127
// (zeros past C) into dst[kFTile][kFCols]; `vec`: 16-byte aligned rows.
__device__ __forceinline__ void load_w_tile(float* dst, const float* w, int k0, int p1,
                                            int c0, int C, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < kFTile * kFCols / 4; i += kFThreads) {
      const int k = i / (kFCols / 4), c = 4 * (i % (kFCols / 4));
      const bool ok = k0 + k < p1 && c0 + c < C;
      cp_async(dst + k * kFCols + c, ok ? w + (long long)(k0 + k) * C + c0 + c : w, ok, true);
    }
  } else {
    for (int i = threadIdx.x; i < kFTile * kFCols; i += kFThreads) {
      const int k = i / kFCols, c = i % kFCols;
      const bool ok = k0 + k < p1 && c0 + c < C;
      cp_async(dst + i, ok ? w + (long long)(k0 + k) * C + c0 + c : w, ok, false);
    }
  }
}

// The A values of a k-tile at k0 that a thread stages: A[j][k0 + k] =
// ce[b][k0 + k][e] obj[b][k0 + k] for the thread's one factor row
// j = j0 + threadIdx.x % R = b E + e (kFThreads is a multiple of R) and rows
// k = threadIdx.x / R + t kFThreads / R. They are kept as the loaded ce and
// obj (zeros outside A) and multiplied when stored, so that the loads stay
// in flight while the current k-tile is summed.
template <typename T, int RPT>
struct ATile {
  static constexpr int R = kFRows<RPT>, kN = kFTile * R / kFThreads;
  T ce[kN];
  float obj[kN];

  __device__ __forceinline__ void load(const T* ce_g, const float* obj_g, bool row_ok,
                                       long long b_p, int e, int E, int k0, int p1) {
#pragma unroll
    for (int t = 0; t < kN; ++t) {
      const int p = k0 + (int)threadIdx.x / R + t * (kFThreads / R);
      if (row_ok && p < p1) {
        ce[t] = ce_g[(b_p + p) * E + e];
        obj[t] = obj_g[b_p + p];
      } else {
        ce[t] = T(0.f);
        obj[t] = 0.f;
      }
    }
  }

  __device__ __forceinline__ void store(float* dst) const {  // dst[k][R]
#pragma unroll
    for (int t = 0; t < kN; ++t) dst[threadIdx.x + t * kFThreads] = to_float(ce[t]) * obj[t];
  }
};

// Pass 1: M[j][c] = sum over p of A[j][p] W[p][c], A[b*E + e][p] =
// ce[b][p][e] obj[b][p], for the block's R x 128 tile: split blockIdx.z of
// P here, then the cluster's S partial tiles summed in rank order.
template <typename T, int RPT>
__global__ void __launch_bounds__(kFThreads, 2)
factor_kernel(const T* __restrict__ ce, const float* __restrict__ obj,
              const float* __restrict__ w, float* __restrict__ m, int B, int P,
              int E, int C, bool vec) {
  constexpr int R = kFRows<RPT>;
  static_assert(kFThreads % R == 0, "a thread stages one factor row");
  static_assert(R * kFCols <= 2 * kFTile * (R + kFCols), "the partial tile fits");
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                    // [2][kFTile][R]
  float* w_s = smem + 2 * kFTile * R;   // [2][kFTile][kFCols]
  const int c0 = blockIdx.x * kFCols;
  const int j0 = blockIdx.y * R;
  const int J = B * E;
  const int ktiles = (P + kFTile - 1) / kFTile, S = gridDim.z;
  const int p0 = (int)((long long)blockIdx.z * ktiles / S) * kFTile;
  const int p1 = min(P, (int)((long long)(blockIdx.z + 1) * ktiles / S) * kFTile);
  const int tx = threadIdx.x % kFGroups;  // columns 4 tx .. and 64 + 4 tx ..
  const int ty = threadIdx.x / kFGroups;  // factor rows RPT ty ..
  const int tiles = (p1 - p0 + kFTile - 1) / kFTile;
  const int ja = j0 + threadIdx.x % R;    // the factor row this thread stages
  const int ba = ja / E;
  const long long b_p = (long long)ba * P;

  float acc[RPT][8];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  ATile<T, RPT> a_next;
  a_next.load(ce, obj, ja < J, b_p, ja - ba * E, E, p0, p1);
  load_w_tile(w_s, w, p0, p1, c0, C, vec);
  cp_async_commit();
  for (int kt = 0; kt < tiles; ++kt) {
    float* at = a_s + (kt & 1) * kFTile * R;
    const float* wt = w_s + (kt & 1) * kFTile * kFCols;
    a_next.store(at);
    if (kt + 1 < tiles) {  // the other buffers' readers finished tile kt - 1
      const int k1 = p0 + (kt + 1) * kFTile;
      load_w_tile(w_s + ((kt + 1) & 1) * kFTile * kFCols, w, k1, p1, c0, C, vec);
      a_next.load(ce, obj, ja < J, b_p, ja - ba * E, E, k1, p1);
    }
    cp_async_commit();   // an empty group on the last tile keeps the count
    cp_async_wait<1>();  // this tile's W has landed
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kFTile; ++k) {
      float x[RPT];
      if constexpr (RPT % 4 == 0) {
#pragma unroll
        for (int i = 0; i < RPT; i += 4) {
          const float4 v = *reinterpret_cast<const float4*>(at + k * R + RPT * ty + i);
          x[i] = v.x;
          x[i + 1] = v.y;
          x[i + 2] = v.z;
          x[i + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < RPT; ++i) x[i] = at[k * R + RPT * ty + i];
      }
      const float4 y0 = *reinterpret_cast<const float4*>(wt + k * kFCols + 4 * tx);
      const float4 y1 = *reinterpret_cast<const float4*>(wt + k * kFCols + 64 + 4 * tx);
      const float y[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
      }
    }
    __syncthreads();  // this tile's buffers are free again
  }
  cp_async_wait<0>();

  // the split's partial tile into this block's shared memory, then each
  // block of the cluster sums its share of rows over the S tiles
  float* part = smem;  // [R][kFCols], over a_s and w_s
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    float* row = part + (RPT * ty + i) * kFCols;
    *reinterpret_cast<float4*>(row + 4 * tx) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 64 + 4 * tx) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = (int)cluster.block_rank();  // blockIdx.z: one cluster spans z
  const int rb = rank * R / S, re = (rank + 1) * R / S;
  for (int i = threadIdx.x; i < (re - rb) * (kFCols / 4); i += kFThreads) {
    const int r = rb + i / (kFCols / 4), c = 4 * (i % (kFCols / 4));
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < S; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, q) + r * kFCols + c);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    if (j0 + r < J) {
      float* dst = m + (long long)(j0 + r) * C + c0 + c;
      const float v[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (c0 + c + jj < C) dst[jj] = v[jj];
      }
    }
  }
  cluster.sync();  // the other blocks have read this block's tile
}

// ---- pass 2 ------------------------------------------------------------

// v[0 .. kVec - 1] to dst (only the first `left`), streaming; `vec`: 16-byte
// aligned rows.
__device__ __forceinline__ void store_vec(float* dst, const float* v, int left, bool vec) {
  if (vec && left >= 4) {
    __stcs(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < left) __stcs(dst + j, v[j]);
  }
}

__device__ __forceinline__ void store_vec(bf16* dst, const float* v, int left, bool vec) {
  if (vec && left >= 8) {
    uint4 packed;
    uint32_t* words = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      words[j] = *reinterpret_cast<const uint32_t*>(&pair);
    }
    __stcs(reinterpret_cast<uint4*>(dst), packed);
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < left) {
      __stcs(reinterpret_cast<unsigned short*>(dst + j),
             __bfloat16_as_ushort(__float2bfloat16_rn(v[j])));
    }
  }
}

// Pass 2: out[b][p][c] = ReLU(sum_e ce[b][p][e] M[b][e][c] + bias[c]) for
// the rows p of row range blockIdx.x (`rows_per_block` rows), the columns of
// chunk blockIdx.y, batch row blockIdx.z.
template <typename T, int kEC>
__global__ void __launch_bounds__(kXThreads)
expand_kernel(const T* __restrict__ ce, const float* __restrict__ m,
              const float* __restrict__ bias, T* __restrict__ out, int P, int E, int C,
              int rows_per_block, bool vec) {
  constexpr int V = kVec<T>, kLanes = kXLanes<T>, kSub = kXSub<T>;
  constexpr int kRowLanes = kXThreads / kLanes;  // rows in flight
  extern __shared__ __align__(16) float smem[];
  float* m_s = smem;                  // [kEC][kXCols]: the chunk of M
  float* ce_s = smem + kEC * kXCols;  // [kSub][kEC]
  const int r0 = blockIdx.x * rows_per_block, r1 = min(P, r0 + rows_per_block);
  const int c0 = blockIdx.y * kXCols;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % kLanes, ty = threadIdx.x / kLanes;
  const int c = c0 + V * tx;
  const T* ce_b = ce + (long long)b * P * E;
  T* out_b = out + (long long)b * P * C;
  float bv[V];
#pragma unroll
  for (int j = 0; j < V; ++j) bv[j] = c + j < C ? __ldg(bias + c + j) : 0.f;

  // steps: (row sub-tile, E chunk) pairs in order; each step's ce values
  // are loaded during the step before, as raw values, and widened when
  // stored
  constexpr int kCePer = (kSub * kEC + kXThreads - 1) / kXThreads;
  const int nchunks = (E + kEC - 1) / kEC;
  const int steps = (r1 - r0 + kSub - 1) / kSub * nchunks;
  T ce_next[kCePer];
  auto load_ce = [&](int step) {
    const int row0 = r0 + step / nchunks * kSub, e0 = step % nchunks * kEC;
#pragma unroll
    for (int t = 0; t < kCePer; ++t) {
      const int i = threadIdx.x + t * kXThreads, r = i / kEC, e = i % kEC;
      ce_next[t] = i < kSub * kEC && row0 + r < r1 && e0 + e < E
                       ? ce_b[(long long)(row0 + r) * E + e0 + e] : T(0.f);
    }
  };
  load_ce(0);
  float acc[kXPerThread][V];
  for (int step = 0; step < steps; ++step) {
    const int row0 = r0 + step / nchunks * kSub, chunk = step % nchunks, e0 = chunk * kEC;
    if (chunk == 0) {
#pragma unroll
      for (int i = 0; i < kXPerThread; ++i) {
#pragma unroll
        for (int j = 0; j < V; ++j) acc[i][j] = 0.f;
      }
    }
    __syncthreads();  // the last readers of m_s and ce_s are done
    if (step == 0 || nchunks > 1) {  // M's chunk: once, unless E takes chunks
#pragma unroll
      for (int t = 0; t < kEC; ++t) {
        const int i = threadIdx.x + t * kXThreads, e = i / kXCols, cc = i % kXCols;
        m_s[i] = e0 + e < E && c0 + cc < C
                     ? __ldg(m + ((long long)b * E + e0 + e) * C + c0 + cc) : 0.f;
      }
    }
#pragma unroll
    for (int t = 0; t < kCePer; ++t) {
      const int i = threadIdx.x + t * kXThreads;
      if (i < kSub * kEC) ce_s[i] = to_float(ce_next[t]);
    }
    if (step + 1 < steps) load_ce(step + 1);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kEC; ++e) {
      float mv[V];
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        const float4 x = *reinterpret_cast<const float4*>(m_s + e * kXCols + V * tx + j);
        mv[j] = x.x;
        mv[j + 1] = x.y;
        mv[j + 2] = x.z;
        mv[j + 3] = x.w;
      }
#pragma unroll
      for (int i = 0; i < kXPerThread; ++i) {
        const float a = ce_s[(ty + kRowLanes * i) * kEC + e];
#pragma unroll
        for (int j = 0; j < V; ++j) acc[i][j] = fmaf(a, mv[j], acc[i][j]);
      }
    }
    if (chunk == nchunks - 1 && c < C) {
#pragma unroll
      for (int i = 0; i < kXPerThread; ++i) {
        const int r = row0 + ty + kRowLanes * i;
        if (r >= r1) break;
        float v[V];
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = fmaxf(acc[i][j] + bv[j], 0.f);
        store_vec(out_b + (long long)r * C + c, v, C - c, vec);
      }
    }
  }
}

template <typename T, int RPT>
int launch_factor(const T* ce, const float* obj, const float* w, float* m, int B, int P,
                  int E, int C, cudaStream_t stream) {
  constexpr size_t bytes = kFactorSmem<RPT>;
  auto* kernel = factor_kernel<T, RPT>;
  int err = dcnet::prepare_smem(kernel, bytes);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  const int chunks = (C + kFCols - 1) / kFCols;
  const int row_tiles = (int)(((long long)B * E + kFRows<RPT> - 1) / kFRows<RPT>);
  const int S = splits(chunks * row_tiles, P);
  const bool vec = reinterpret_cast<uintptr_t>(w) % 16 == 0 && C % 4 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(chunks, row_tiles, S);
  cfg.blockDim = dim3(kFThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = S;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, ce, obj, w, m, B, P, E, C, vec);
}

template <typename T, int kEC>
int launch_expand(const T* ce, const float* m, const float* bias, T* out, int B, int P,
                  int E, int C, cudaStream_t stream) {
  constexpr size_t bytes = kExpandSmem<T, kEC>;
  const int err = dcnet::prepare_smem(expand_kernel<T, kEC>, bytes);
  if (err != 0) return err;
  // rows a block: whole sub-tiles, as many as keep about kXBlocksPerSM
  // blocks an SM
  const int chunks = (C + kXCols - 1) / kXCols;
  const long long subs = (P + kXSub<T> - 1) / kXSub<T>;
  const long long per = std::max<long long>(
      1, subs * chunks * B / ((long long)kXBlocksPerSM * kSMs));
  const int rows = (int)std::min<long long>(per, subs) * kXSub<T>;
  const bool vec = reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   ((long long)C * sizeof(T)) % 16 == 0;
  const dim3 grid((P + rows - 1) / rows, chunks, B);
  expand_kernel<T, kEC><<<grid, kXThreads, bytes, stream>>>(ce, m, bias, out, P, E, C, rows,
                                                            vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* ce_v, const float* obj, const float* w, const float* bias,
           void* out_v, float* m, int B, int P, int E, int C, cudaStream_t s) {
  const T* ce = static_cast<const T*>(ce_v);
  T* out = static_cast<T*>(out_v);
  const long long J = (long long)B * E;  // factor rows: tiles of 16, 32 or 64
  const int err = J <= kFRows<2>   ? launch_factor<T, 2>(ce, obj, w, m, B, P, E, C, s)
                  : J <= kFRows<4> ? launch_factor<T, 4>(ce, obj, w, m, B, P, E, C, s)
                                   : launch_factor<T, 8>(ce, obj, w, m, B, P, E, C, s);
  if (err != 0) return err;
  if (E <= 1) return launch_expand<T, 1>(ce, m, bias, out, B, P, E, C, s);
  if (E <= 2) return launch_expand<T, 2>(ce, m, bias, out, B, P, E, C, s);
  if (E <= 4) return launch_expand<T, 4>(ce, m, bias, out, B, P, E, C, s);
  if (E <= 8) return launch_expand<T, 8>(ce, m, bias, out, B, P, E, C, s);
  return launch_expand<T, kMaxEC>(ce, m, bias, out, B, P, E, C, s);
}

}  // namespace

extern "C" {

// ce (B, P, E) contiguous, dtype 0 = float32, 1 = bfloat16; obj (B, P), w
// (P, C) and bias (C,) contiguous float32; out (B, P, C) contiguous in ce's
// dtype; m: a (B, E, C) float32 workspace (the factor). Any B <= 65535 and
// P, E, C >= 1 with B * E <= 64 * 65535 (factor row tiles are a grid
// dimension). Returns a cudaError_t code, 0 on success.
int dcnet_loc_gram(const void* ce, const void* obj, const void* w,
                   const void* bias, void* out, void* m, int B, int P, int E,
                   int C, int dtype, void* stream) {
  if (B <= 0 || P <= 0 || E <= 0 || C <= 0 || B > 65535 ||
      (long long)B * E > 64LL * 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* o = static_cast<const float*>(obj);
  const float* wt = static_cast<const float*>(w);
  const float* bs = static_cast<const float*>(bias);
  float* mf = static_cast<float*>(m);
  if (dtype == 0) return launch<float>(ce, o, wt, bs, out, mf, B, P, E, C, s);
  if (dtype == 1) return launch<bf16>(ce, o, wt, bs, out, mf, B, P, E, C, s);
  return (int)cudaErrorInvalidValue;
}

const char* dcnet_loc_gram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
